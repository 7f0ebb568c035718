"""The scoring back end: counterpart of wespeaker_tpu/backend (metrics,
cosine / AS-Norm scoring, PLDA, QMF calibration and the embedding
processing chain)."""
from wespeaker_tpu_torch.backend.calibration import (  # noqa: F401
    QMFCalibrator,
    build_factors,
    cllr,
)
from wespeaker_tpu_torch.backend.embedding_processing import (  # noqa: F401
    EmbeddingProcessingChain,
)
from wespeaker_tpu_torch.backend.metrics import (  # noqa: F401
    compute_metrics,
    eer,
    labels_from_strings,
    min_dcf,
    pmiss_pfa,
)
from wespeaker_tpu_torch.backend.plda import TwoCovPLDA  # noqa: F401
from wespeaker_tpu_torch.backend.scoring import (  # noqa: F401
    TrialScorer,
    asnorm_scores,
    cohort_mean_std,
    compute_mean_vec,
    cosine_scores,
    read_trials,
)
