from gphocs_tpu_torch.kernels.common import Context, make_context  # noqa: F401
