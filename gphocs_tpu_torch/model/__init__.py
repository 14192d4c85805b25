from gphocs_tpu_torch.model.poptree import PopTree, build_poptree  # noqa: F401
