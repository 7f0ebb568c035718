from wespeaker_tpu_torch.train.train_step import make_eval_embed_fn  # noqa: F401
