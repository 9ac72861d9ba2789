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

The front end is the asyncio one (``decoding/aio_serve.py``) unless
``--serve_frontend threads`` is given; ``--backbone_weights`` switches to
the threading one, which alone answers ``/caption_image``. The CLI reads
every flag of the training and eval CLIs, as the JAX serve CLI does;
``--checkpoint_backend orbax`` serves a checkpoint of DCP directories;
``--num_dp_devices``, ``--num_mp_devices``, ``--async_opt`` and
``--eval_ensemble_multi_gpu`` are read and ignored, as the JAX serve CLI
ignores them. ``--serve_dp_devices N`` decodes each batch over a mesh of
the first N cards (``parallel/mesh.py::DeviceMesh``; more than the visible
cards raise), one block of ``--serve_batch_size / N`` rows a card.

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
from .decoding.aio_serve import run_server_async
from .decoding.http_serve import CaptionService, run_server
from .device import resolve_device
from .models import setup
from .parallel.mesh import make_device_mesh, visible_devices
from .training.checkpoint import backend, cast_tree


def build_service(opt, devices=None) -> CaptionService:
    """Checkpoint (written by the JAX package) -> a running CaptionService
    on ``opt.device``, in ``opt.serve_dtype``; with --serve_dp_devices N >
    1 on a mesh of the first N of ``devices`` (default: the visible cards,
    or the one CPU under --device cpu; JAX serve.py:101-104)."""
    device = resolve_device(opt.device)  # before reading the checkpoint
    mesh = None
    n_devices = getattr(opt, "serve_dp_devices", 1)  # parse_opt's options have none
    if n_devices > 1:
        mesh = make_device_mesh(n_devices, visible_devices(opt.device)
                                if devices is None else devices)
        device = mesh.devices[0]
    params, infos = backend(opt).load_checkpoint(
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
                          beam_size=opt.beam_size, depth=opt.serve_depth, backbone=backbone,
                          mesh=mesh)


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
    frontend = opt.serve_frontend
    if service.backbone is not None and frontend == "asyncio":
        # /caption_image decodes images on the CPU; keep it off the loop
        print("--backbone_weights set: using the threading front end "
              "(/caption_image support)", flush=True)
        frontend = "threads"
    where = (service.device if service.mesh is None
             else "mesh " + ",".join(str(d) for d in service.mesh.devices))
    ready = (f"(batch {opt.serve_batch_size}, beam {opt.beam_size}, {opt.serve_dtype}, "
             f"{where}, {frontend})")
    if frontend == "asyncio":
        fe = run_server_async(service, opt.host, opt.port)
        print(f"caption service on {opt.host}:{fe.port} {ready}", flush=True)
        stop.wait()
        print("shutting down: draining in-flight requests", flush=True)
        fe.stop(drain=True, timeout=opt.drain_timeout)
        service.close()
        print("shutdown complete", flush=True)
        return
    httpd = run_server(service, opt.host, opt.port)
    host, port = httpd.server_address[:2]
    print(f"caption service on {host}:{port} {ready}", flush=True)
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
