"""Serving CLI: config + checkpoint -> HTTP embedding daemon on the card.

    python -m wespeaker_tpu_torch.bin.serve --config conf.yaml \
        --checkpoint model.pt|model.ckpt [--device cuda] [k=v overrides]

Counterpart of wespeaker_tpu/bin/serve.py (wespeaker_tpu_torch/serving.py
holds the batcher and server). The checkpoint is a torch state_dict or
the JAX package's msgpack `.ckpt`.
"""

import argparse
import logging

from wespeaker_tpu_torch.serving import EmbeddingServer
from wespeaker_tpu_torch.utils.config import parse_config_or_kwargs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8086)
    ap.add_argument("--max_batch", type=int, default=16)
    ap.add_argument("--max_wait_ms", type=float, default=5.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    configs = parse_config_or_kwargs(args.config, args.overrides)
    server = EmbeddingServer(configs, args.checkpoint, host=args.host,
                             port=args.port, max_batch=args.max_batch,
                             max_wait_ms=args.max_wait_ms, device=args.device)
    logging.info("serving on %s:%d (POST /embed, /diarize, /similarity; "
                 "GET /health)", args.host, server.port)
    try:
        server.httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()


if __name__ == "__main__":
    main()
