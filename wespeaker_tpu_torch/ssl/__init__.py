"""Self-supervised pretraining: DINO (`dino`), MoCo and SimCLR
(`contrastive`), their multi-view data stages (`dataset`) and per-view
features (`featurize`)."""
