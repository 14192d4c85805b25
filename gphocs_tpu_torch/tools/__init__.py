"""Command-line tools of gphocs_tpu_torch."""
