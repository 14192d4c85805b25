from gphocs_tpu_torch.config.settings import (  # noqa: F401
    BandSpec,
    Finetunes,
    MCMCSettings,
    PopSpec,
    RunConfig,
)
from gphocs_tpu_torch.config.control import parse_control_file, parse_control_text  # noqa: F401
