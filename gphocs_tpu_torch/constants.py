"""Program-wide constants.

Mirrors the reference's compile-time constants (reference: src/patch.h:17-22,
src/GPhoCS.h:21-33) — but in this implementation most of them are soft
defaults used only for padding/bucketing decisions, not hard limits.
"""

# Age ceiling for the root population interval (reference: src/GPhoCS.h "OLDAGE 999").
OLDAGE = 999.0

# Maximum migration events per locus genealogy (reference: src/patch.h MAX_MIGS=10).
# Used as padding size of the per-locus migration tensors; configurable per run.
MAX_MIGS = 10

# Finetune auto-search constants (reference: src/GPhoCS.h:21-25).
TARGET_ACCEPTANCE_PERCENT = 35.0
TARGET_ACCEPTANCE_RANGE = 5.0
FINETUNE_RESOLUTION = 1e-7
MAX_FINETUNE = 10.0

# Proposal auto-reject threshold for migration rates
# (reference: src/GPhoCS.c:3159 "if (new_rate < 0.00001) continue;").
MIN_MIG_RATE = 1e-5
