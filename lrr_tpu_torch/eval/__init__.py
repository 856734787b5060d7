from lrr_tpu_torch.eval.compare import compare_descriptor_sets
from lrr_tpu_torch.eval.indexing_eval import evaluate_indexing
from lrr_tpu_torch.eval.repeatability import feature_repeatability

__all__ = [
    "feature_repeatability",
    "evaluate_indexing",
    "compare_descriptor_sets",
]
