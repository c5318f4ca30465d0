from pbr_tpu_torch.accel.bvh import BuildStats, build_bvh  # noqa: F401
