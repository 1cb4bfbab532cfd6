from lseg_tpu_torch.engine.tta import MultiScaleEvaluator, TTAProtocol  # noqa: F401
from lseg_tpu_torch.engine.eval_single import SingleScaleEvaluator  # noqa: F401
from lseg_tpu_torch.engine.serve import make_predictor, make_logits_fn  # noqa: F401
from lseg_tpu_torch.engine.episodic import (  # noqa: F401
    EpisodicEvaluator,
    make_episodic_predictor,
)
