"""The scoring back end: what is ported of wespeaker_tpu/backend (metrics
and cosine / AS-Norm scoring). PLDA, calibration and embedding processing
are not ported yet."""
from wespeaker_tpu_torch.backend.metrics import (  # noqa: F401
    compute_metrics,
    eer,
    labels_from_strings,
    min_dcf,
    pmiss_pfa,
)
from wespeaker_tpu_torch.backend.scoring import (  # noqa: F401
    TrialScorer,
    asnorm_scores,
    cohort_mean_std,
    compute_mean_vec,
    cosine_scores,
    read_trials,
)
