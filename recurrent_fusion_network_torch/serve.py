"""Caption-serving entry point: an HTTP service over a trained checkpoint.

Loads a checkpoint written by the JAX package, converts its parameters and
serves beam-search captions from the GPU; concurrent requests coalesce into
static-shape device batches (``decoding/http_serve.py``).

  python -m recurrent_fusion_network_torch.serve --model_path checkpoint \\
      --load_model_id myrun --beam_size 3 --serve_batch_size 16 --port 8080
  curl localhost:8080/healthz
  curl -X POST localhost:8080/caption -d '{"fc": [[...]], "att": [[[...]]]}'

With ``--backbone_weights F`` (a torchvision state dict, or a flat npz for
the inception nets; ``--backbone_arch``, default resnet101) it also answers
``POST /caption_image`` with an image file as the body
(``curl --data-binary @img.jpg localhost:8080/caption_image``). As in the
JAX package, the backbone runs at 448 px with a 14 x 14 grid whatever the
arch.

It runs on CUDA unless ``--device cpu`` is given, and raises when CUDA is
absent otherwise. SIGTERM / SIGINT drain in-flight requests and exit 0.
"""

from __future__ import annotations

import signal
import threading

import torch

from .config import merge_checkpoint_opt, parse_serve_opt
from .convert import check_params, params_from_jax
from .data.feature_extraction.backbones import build_backbone
from .decoding.http_serve import CaptionService, run_server
from .device import resolve_device
from .models import setup
from .training.checkpoint import cast_tree, load_checkpoint


def build_service(opt) -> CaptionService:
    """Checkpoint (written by the JAX package) -> a running CaptionService
    on ``opt.device``, in ``opt.serve_dtype``."""
    device = resolve_device(opt.device)  # before reading the checkpoint
    params, infos = load_checkpoint(
        opt.model_path or opt.checkpoint_path, opt.load_model_id, opt.rank,
        best=True, prefix="rl_" if opt.rl_prefix else "")
    if "opt" in infos:
        merge_checkpoint_opt(opt, infos["opt"])
    vocab = infos.get("vocab")
    if not vocab:
        raise ValueError("checkpoint infos hold no vocab")
    opt.vocab_size = len(vocab)
    opt.seq_length = infos.get("opt", {}).get("seq_length") or 16
    model = setup(opt)
    params = params_from_jax(params)
    check_params(model, params)
    if opt.serve_dtype == "bfloat16":
        params = cast_tree(params, torch.bfloat16)
    backbone = None
    if opt.backbone_weights:
        bb_params, feats_fn, _, _ = build_backbone(opt.backbone_arch, 14, opt.backbone_weights,
                                                   device=device)
        backbone = (bb_params, feats_fn, 448)
    return CaptionService(model, params, vocab, device=device,
                          batch_size=opt.serve_batch_size,
                          beam_size=opt.beam_size, depth=opt.serve_depth, backbone=backbone)


def main(argv=None):
    opt = parse_serve_opt(argv)
    service = build_service(opt)
    # installed before warmup, so a signal during warmup still exits 0
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    print("warming up the decode path...", flush=True)
    service.warmup()
    if stop.is_set():
        service.close()
        print("shutdown complete", flush=True)
        return
    httpd = run_server(service, opt.host, opt.port)
    host, port = httpd.server_address[:2]
    print(f"caption service on {host}:{port} (batch {opt.serve_batch_size}, "
          f"beam {opt.beam_size}, {opt.serve_dtype}, {service.device})",
          flush=True)
    stop.wait()
    print("shutting down: draining in-flight requests", flush=True)
    httpd.shutdown()  # stop accepting; active handler threads continue
    service.close()  # resolves the futures the handler threads wait on
    closer = threading.Thread(target=httpd.server_close, daemon=True)
    closer.start()
    closer.join(opt.drain_timeout)
    print("shutdown complete", flush=True)


if __name__ == "__main__":
    main()
