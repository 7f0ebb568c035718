"""Feature frontends. Only the Kaldi fbank is ported so far."""

from wespeaker_tpu_torch.frontend.fbank import (  # noqa: F401
    EPSILON,
    FbankConfig,
    apply_cmvn,
    compute_fbank,
    make_mel_banks,
    make_window,
)
