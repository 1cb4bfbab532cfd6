from lseg_tpu_torch.utils.logging import Logger  # noqa: F401
from lseg_tpu_torch.utils.palette import class_palette, colorize, overlay  # noqa: F401
from lseg_tpu_torch.utils.seed import fix_randseed  # noqa: F401
