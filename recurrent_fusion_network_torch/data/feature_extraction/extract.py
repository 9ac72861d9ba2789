"""Feature extraction CLI.

Counterpart of ``recurrent_fusion_network_tpu/data/feature_extraction/
extract.py`` (the reference's extract_*_feats.py scripts), on the GPU:

  * images resized to a fixed --image_size (default: the arch's native
    size, resnet 448 -> an exact 14 x 14 grid) and run in batches;
  * each image is decoded once, and the requested augmentation variants
    (``augment.py``) are made from that batch on the device;
  * output is the packed layout the loader reads ({variant}_fc.npy /
    {variant}_att.npy + ids.json), or a sharded store (``data/sharded.py``);
  * preemptible: a progress marker bound to the work list and the weights
    is written at flush boundaries and on SIGTERM; running the same command
    again resumes at the recorded row (--resume 0 starts afresh).

Weights: --torch_weights <torchvision resnet*/densenet*.pth, or a flat npz
for the inception nets>; without it the backbone is randomly initialized
(pipeline smoke runs only). It runs on CUDA unless --device cpu is given,
and raises when CUDA is absent otherwise:

  python -m recurrent_fusion_network_torch.data.feature_extraction.extract \\
      --images_dir val2014/ --output_dir data/features/resnet/packed \\
      --arch resnet101 --variants original,flip --batch_size 16
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil

import numpy as np
import torch

from ...device import resolve_device
from ...training.preempt import PreemptGuard
from .augment import VARIANTS, make_variant
from .backbones import ARCHS, build_backbone, output_shapes

# native geometry per arch family (image_size, att_size): the input size the
# weights were trained for and the grid it gives, matching the registry's
# dims (resnet 448 -> 14 x 14 by adaptive pooling, densenet161 224 -> 7 x 7,
# inception 299 -> 8 x 8 fixed)
ARCH_GEOMETRY = {
    "resnet": (448, 14),
    "densenet": (224, 7),
    "inception": (299, 8),
}


def default_geometry(arch: str):
    for prefix, geo in ARCH_GEOMETRY.items():
        if arch.startswith(prefix):
            return geo
    raise ValueError(f"no native geometry known for arch {arch}")


def load_image(path: str, size: int) -> np.ndarray:
    """An image file -> (size, size, 3) f32 in [0, 1], PIL BILINEAR resize."""
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((size, size), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


def image_id_from_name(name: str) -> int:
    """COCO_val2014_000000391895.jpg -> 391895; plain '123.jpg' -> 123."""
    stem = os.path.splitext(os.path.basename(name))[0]
    return int(stem.split("_")[-1])


def list_images(folder: str):
    return sorted(f for f in os.listdir(folder) if f.lower().endswith((".jpg", ".jpeg", ".png")))


def load_batch(folder: str, names, size: int, device) -> torch.Tensor:
    """Decode and resize ``names`` on the host -> (B, size, size, 3) on the
    device."""
    imgs = torch.from_numpy(np.stack([load_image(os.path.join(folder, n), size)
                                      for n in names]))
    if device.type == "cuda":
        imgs = imgs.pin_memory()
    return imgs.to(device, non_blocking=True)


def weights_fingerprint(path):
    if not path:
        return None
    st = os.stat(path)
    return [os.path.abspath(path), st.st_size, st.st_mtime_ns]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="CNN feature extraction (PyTorch)")
    p.add_argument("--images_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--arch", default="resnet101", choices=list(ARCHS))
    p.add_argument("--torch_weights", default=None)
    p.add_argument("--image_size", type=int, default=None,
                   help="input resolution; default: the arch's native size "
                        "(resnet 448, densenet 224, inception 299)")
    p.add_argument("--att_size", type=int, default=None,
                   help="spatial grid side; default: the arch's native grid "
                        "(resnet 14, densenet 7, inception 8); checked "
                        "against the backbone's output before any IO")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--variants", default="original",
                   help=f"comma list from {','.join(VARIANTS)} or 'all'")
    p.add_argument("--limit", type=int, default=-1)
    p.add_argument("--output_format", default="packed", choices=("packed", "sharded"),
                   help="packed: one mmap array per variant; sharded: fixed-size row "
                        "shards + manifest (data/sharded.py)")
    p.add_argument("--shard_size", type=int, default=4096)
    p.add_argument("--resume", type=int, default=1,
                   help="continue an interrupted extraction from its progress marker "
                        "(SIGTERM writes it); 0 = always start afresh")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    native_imsz, native_att = default_geometry(args.arch)
    if args.image_size is None:
        args.image_size = native_imsz
    if args.att_size is None:
        args.att_size = native_att

    params, feats_fn, C_fc, C_att = build_backbone(args.arch, args.att_size,
                                                   args.torch_weights, device=device)

    # the (image_size, att_size) pair against the backbone's output grid,
    # before any array is opened: inception grids are set by the input size
    # (att_size is not read there), and a mismatch would otherwise fail at
    # the first batch or write a geometry the registry contradicts
    _, att_shape = output_shapes(feats_fn, params, args.image_size)
    npos = att_shape[1] * att_shape[2]
    if npos != args.att_size ** 2 or att_shape[-1] != C_att:
        raise SystemExit(
            f"--arch {args.arch} at --image_size {args.image_size} produces an att grid "
            f"of {npos} positions x {att_shape[-1]} channels; --att_size {args.att_size} "
            f"wants {args.att_size ** 2}. Use the native geometry (--image_size "
            f"{native_imsz} --att_size {native_att}) or a consistent override.")

    variants = VARIANTS if args.variants == "all" else tuple(args.variants.split(","))
    for v in variants:
        if v not in VARIANTS:
            raise SystemExit(f"unknown variant {v!r}; choose from {','.join(VARIANTS)}")
    names = list_images(args.images_dir)
    if args.limit > 0:
        names = names[: args.limit]
    ids = [image_id_from_name(n) for n in names]
    N, B, S = len(names), args.batch_size, args.att_size

    out_dir = args.output_dir
    pack_dir = out_dir if args.output_format == "packed" else out_dir + ".packed_tmp"
    os.makedirs(pack_dir, exist_ok=True)

    # the marker binds to the work list (names, dims, variants) and the
    # weights (path, size, mtime): any mismatch starts afresh, so a random
    # dry run never satisfies or extends a marker once real weights appear
    meta = {
        "n": N,
        "variants": list(variants),
        "arch": args.arch,
        "att_size": S,
        "image_size": args.image_size,
        "torch_weights": weights_fingerprint(args.torch_weights),
        "names_sha1": hashlib.sha1("\n".join(names).encode()).hexdigest(),
    }
    progress_path = os.path.join(pack_dir, "progress.json")
    done_rows = 0
    if args.resume and os.path.exists(progress_path):
        with open(progress_path) as f:
            prog = json.load(f)
        if all(prog.get(k) == v for k, v in meta.items()):
            done_rows = int(prog.get("done", 0))
            print(f"resuming extraction at row {done_rows}/{N}")
        else:
            print("progress marker does not match this invocation — starting fresh")

    def write_progress(done):
        tmp = progress_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({**meta, "done": done}, f)
        os.replace(tmp, progress_path)

    # SIGTERM sets a flag; the loop checkpoints at the next chunk
    guard = PreemptGuard(enabled=True).install()

    # rows stream straight into the on-disk arrays (at COCO scale the att
    # matrix is ~200 GB per variant)
    if done_rows and not all(os.path.exists(os.path.join(pack_dir, f"{v}_{kind}.npy"))
                             for v in variants for kind in ("fc", "att")):
        print("progress marker without its arrays — starting fresh")
        done_rows = 0
    fc_outs, att_outs = {}, {}
    for variant in variants:
        fc_path = os.path.join(pack_dir, f"{variant}_fc.npy")
        att_path = os.path.join(pack_dir, f"{variant}_att.npy")
        if done_rows:
            fc_outs[variant] = np.lib.format.open_memmap(fc_path, mode="r+")
            att_outs[variant] = np.lib.format.open_memmap(att_path, mode="r+")
            if fc_outs[variant].shape != (N, C_fc) or \
                    att_outs[variant].shape != (N, S * S, C_att):
                raise SystemExit(f"{pack_dir}: the {variant} arrays do not have the shapes its "
                                 f"progress marker describes; --resume 0 starts afresh")
        else:
            fc_outs[variant] = np.lib.format.open_memmap(
                fc_path, mode="w+", dtype=np.float32, shape=(N, C_fc))
            att_outs[variant] = np.lib.format.open_memmap(
                att_path, mode="w+", dtype=np.float32, shape=(N, S * S, C_att))

    def flush_all():
        for variant in variants:
            fc_outs[variant].flush()
            att_outs[variant].flush()

    # ids.json marks a complete directory (the loader reads it first): while
    # rows remain, a stale one from an earlier complete run must go
    ids_path = os.path.join(pack_dir, "ids.json")
    if done_rows < N and os.path.exists(ids_path):
        os.unlink(ids_path)

    preempted = False
    for start in range(done_rows, N, B):
        chunk = names[start: start + B]
        n = len(chunk)
        imgs = load_batch(args.images_dir, chunk, args.image_size, device)
        for variant in variants:
            fc, att = feats_fn(params, make_variant(imgs, variant))
            fc_outs[variant][start: start + n] = fc.cpu().numpy()
            att_outs[variant][start: start + n] = att.reshape(n, S * S, C_att).cpu().numpy()
        # one read of the flag per chunk, so the flush, the break and the
        # printed row agree
        stop_now = guard.triggered
        if ((start - done_rows) // B) % 50 == 0 or stop_now:
            flush_all()  # before the marker: it never claims unwritten rows
            write_progress(start + n)
            print(f"{start + n}/{N} images x {len(variants)} variants")
        if stop_now and start + n < N:
            # a signal on the final chunk is completion, not preemption
            print(f"preempted — extraction checkpointed at row {start + n}/{N}; "
                  f"re-run to resume")
            preempted = True
            break
    guard.close()
    flush_all()
    if preempted:
        return
    write_progress(N)
    del fc_outs, att_outs
    with open(ids_path, "w") as f:
        json.dump(ids, f)
    if args.output_format == "sharded":
        from ..sharded import pack_to_shards

        pack_to_shards(pack_dir, out_dir, shard_size=args.shard_size)
        shutil.rmtree(pack_dir)
    print(f"wrote {N} images x {len(variants)} variants to {out_dir} ({args.output_format})")


if __name__ == "__main__":
    main()
