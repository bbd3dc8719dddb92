from bshot_slam_tpu_torch.geometry import se3  # noqa: F401
