"""The benchmark of rocjpeg_tpu_torch: everything but its data files."""
