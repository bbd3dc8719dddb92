"""Keyframes, loop closure, pose graph, bundle adjustment and map
corrections: the port of `bshot_slam_tpu.backend`."""
