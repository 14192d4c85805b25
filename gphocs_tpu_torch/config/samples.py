"""Bundled control texts.

SAMPLE_CTL is the standard workload's configuration (the same text as
gphocs_tpu's tests/test_control.py:SAMPLE_CTL): 4 diploid samples in 4
current + 3 ancestral populations, one migration band D->B, CONST rates.

SAMPLE_AGE_CTL is the ancient-sample configuration: SAMPLE_CTL with an
estimated sample age on population D (`age 0.00002 e`; D's father is the
root, tau 5e-5, so the age starts inside its bounds).  It is the
population tree and age line of CTL_SAMPLE_AGE in gphocs_tpu's
scripts/golden_compare.py, with SAMPLE_CTL's mixing left on.

WIDE_CTL is SAMPLE_CTL with two diploid samples per population (S = 16
haploid samples, N = 31 nodes): a small configuration in which the SPR
boundary grid (K = N + M + PP + 2B + 1 = 51) and a locus's P x 4
conditionals of a node are both wider than a warp.

SAMPLE_AGE_VAR_CTL adds `locus-mut-rate VAR 1.0` with
`finetune-locus-rate 0.3` (golden_compare.py's CTL_VAR_RATES settings).

S32_CTL is the text of gphocs_tpu's tests/test_samples32.py:S32_CTL: 16
diploid samples (S = 32 haploid, N = 63 nodes, the kernels' MAXN) in
SAMPLE_CTL's population tree and band.  It has `{seq}` and `{trace}`
placeholders for str.format.

ADMIX_CTL is the admixed configuration of gphocs_tpu's
tests/test_sampler.py:test_admixture_end_to_end: SAMPLE_CTL with
`admixture TRUE`, `finetune-admix 0.05`, and sample `one` named in B as
well as in A, so that its two haploid slots are admixed leaves (A = 2)
between A (first) and B (second).  Sequence files simulated under
SAMPLE_CTL serve it: the sample names are the same.  ADMIX_AGE_CTL adds
SAMPLE_AGE_CTL's estimated sample age on D, so that one state drives the
rubber band's two modes under admixture.

`with_settings` replaces or adds GENERAL-INFO settings of a control text.

RAGGED_* describe the ragged workload of gphocs_tpu's
scripts/bench_ragged.py (RAGGED_r03): SAMPLE_CTL, RAGGED_LOCI loci whose
lengths are drawn from RAGGED_LENGTHS with probabilities RAGGED_LENGTH_P by
numpy's RandomState(RAGGED_LENGTH_SEED), simulated with seed
RAGGED_SIM_SEED under θ and τ RAGGED_SCALE times those that
sample_pop_parameters draws from HostRng(RAGGED_LOCI + 1,
RAGGED_PARAM_SEED) (io/simulate.simulate_ragged_file writes it).
"""

import re

SAMPLE_CTL = """
GENERAL-INFO-START
	seq-file            seqs-sample.txt
	trace-file          mcmc.log
	locus-mut-rate          CONST
	mcmc-iterations	  5000
	iterations-per-log  50
	logs-per-line       10
	find-finetunes		FALSE
	finetune-coal-time	0.01
	finetune-mig-time	0.3
	finetune-theta		0.04
	finetune-mig-rate	0.02
	finetune-tau		0.0000008
	finetune-mixing		0.003
#   finetune-locus-rate 0.3
	tau-theta-print		10000.0
	tau-theta-alpha		1.0			# for STD/mean ratio of 100%
	tau-theta-beta		10000.0		# for mean of 1e-4
	mig-rate-print		0.001
	mig-rate-alpha		0.002
	mig-rate-beta		0.00001
GENERAL-INFO-END

CURRENT-POPS-START
	POP-START
		name		A
		samples		one d
	POP-END
	POP-START
		name		B
		samples		two d
	POP-END
	POP-START
		name		C
		samples		three d
	POP-END
	POP-START
		name		D
		samples		five d
	POP-END
CURRENT-POPS-END

ANCESTRAL-POPS-START
	POP-START
		name			AB
		children		A		B
		tau-initial	0.000005
		tau-beta		20000.0
		finetune-tau			0.0000008
	POP-END
	POP-START
		name			ABC
		children		AB		C
		tau-initial	0.00001
		tau-beta		20000.0
		finetune-tau			0.0000008
	POP-END
	POP-START
		name			root
		children		ABC	D
		tau-initial	0.00005
		tau-beta		20000.0
		finetune-tau			0.00000286
	POP-END
ANCESTRAL-POPS-END

MIG-BANDS-START
	BAND-START
       source  D
       target  B
       mig-rate-print 0.1
	BAND-END
MIG-BANDS-END
"""

_D_POP = "\t\tname\t\tD\n\t\tsamples\t\tfive d\n"
SAMPLE_AGE_CTL = SAMPLE_CTL.replace(
    _D_POP, _D_POP + "\t\tage\t\t0.00002\te\n")
assert "age\t\t0.00002" in SAMPLE_AGE_CTL

SAMPLE_AGE_VAR_CTL = SAMPLE_AGE_CTL.replace(
    "\tlocus-mut-rate          CONST",
    "\tlocus-mut-rate      VAR 1.0\n\tfinetune-locus-rate 0.3")
assert "VAR 1.0" in SAMPLE_AGE_VAR_CTL

ADMIX_CTL = SAMPLE_CTL.replace(
    "GENERAL-INFO-END",
    "admixture TRUE\nfinetune-admix 0.05\nGENERAL-INFO-END").replace(
    "samples\t\ttwo d", "samples\t\ttwo d one d")
assert "two d one d" in ADMIX_CTL and "admixture TRUE" in ADMIX_CTL
ADMIX_AGE_CTL = ADMIX_CTL.replace(_D_POP, _D_POP + "\t\tage\t\t0.00002\te\n")
assert "age\t\t0.00002" in ADMIX_AGE_CTL

WIDE_CTL = SAMPLE_CTL
for _name in ("one", "two", "three", "five"):
    WIDE_CTL = WIDE_CTL.replace(f"samples\t\t{_name} d\n",
                                f"samples\t\t{_name} d {_name}b d\n")
del _name

S32_CTL = """
GENERAL-INFO-START
    seq-file            {seq}
    trace-file          {trace}
    locus-mut-rate      CONST
    mcmc-iterations     40
    burn-in             0
    random-seed         19
    mcmc-sample-skip    0
    start-mig 0
    iterations-per-log  1000
    logs-per-line       10
    find-finetunes      FALSE
    finetune-coal-time  0.01
    finetune-mig-time   0.3
    finetune-theta      0.04
    finetune-mig-rate   0.02
    finetune-tau        0.0000008
    finetune-mixing     0.003
    tau-theta-print     10000.0
    tau-theta-alpha     1.0
    tau-theta-beta      10000.0
    mig-rate-print      0.001
    mig-rate-alpha      0.002
    mig-rate-beta       0.00001
GENERAL-INFO-END
CURRENT-POPS-START
    POP-START
        name  A
        samples  a1 d a2 d a3 d a4 d
    POP-END
    POP-START
        name  B
        samples  b1 d b2 d b3 d b4 d
    POP-END
    POP-START
        name  C
        samples  c1 d c2 d c3 d c4 d
    POP-END
    POP-START
        name  D
        samples  d1 d d2 d d3 d d4 d
    POP-END
CURRENT-POPS-END
ANCESTRAL-POPS-START
    POP-START
        name  AB
        children  A  B
        tau-initial 0.000005
        tau-beta  20000.0
    POP-END
    POP-START
        name  ABC
        children  AB  C
        tau-initial 0.00001
        tau-beta  20000.0
    POP-END
    POP-START
        name  root
        children  ABC  D
        tau-initial 0.00005
        tau-beta  20000.0
    POP-END
ANCESTRAL-POPS-END
MIG-BANDS-START
    BAND-START
       source  D
       target  B
       mig-rate-print 0.1
    BAND-END
MIG-BANDS-END
"""

RAGGED_LOCI = 4000
RAGGED_LENGTHS = (100, 200, 400, 1000, 4000)
RAGGED_LENGTH_P = (0.4, 0.25, 0.2, 0.1, 0.05)
RAGGED_LENGTH_SEED = 3
RAGGED_PARAM_SEED = 7
RAGGED_SCALE = 150.0
RAGGED_SIM_SEED = 13


def with_settings(text: str, **settings) -> str:
    """`text` with GENERAL-INFO settings replaced, or added where absent;
    a keyword names its setting with `-` for `_` (seq_file="x.txt" sets
    `seq-file x.txt`)."""
    for key, value in settings.items():
        name = key.replace("_", "-")
        line = f"\t{name} {value}"
        pat = re.compile(rf"^[ \t]*{re.escape(name)}[ \t].*$", re.M)
        if pat.search(text):
            text = pat.sub(lambda m: line, text, count=1)
        else:
            text = text.replace("GENERAL-INFO-START",
                                "GENERAL-INFO-START\n" + line, 1)
    return text
