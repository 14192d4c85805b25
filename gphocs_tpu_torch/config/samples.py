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
"""

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

WIDE_CTL = SAMPLE_CTL
for _name in ("one", "two", "three", "five"):
    WIDE_CTL = WIDE_CTL.replace(f"samples\t\t{_name} d\n",
                                f"samples\t\t{_name} d {_name}b d\n")
del _name
