from lseg_tpu_torch.utils.seed import fix_randseed  # noqa: F401
