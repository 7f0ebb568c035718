from wespeaker_tpu_torch.train.train_step import (  # noqa: F401
    AugConfig, TrainStep, build_train_state, make_eval_embed_fn,
    make_train_step)
