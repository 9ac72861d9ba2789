"""Cross-entropy training CLI of the port.

Counterpart of the root ``main.py`` (the reference's main.py + train.py),
with the same flags (``config.py``). Runs on the CUDA device unless
``--device cpu``:

  python -m recurrent_fusion_network_torch.main --caption_model recurrent_fusion_model \\
      --feature_type feat_array --data_root data/features --input_json data/cocotalk.json \\
      --input_label_h5 data/cocotalk_label.h5 --batch_size 100 \\
      --save_checkpoint_every 3000 --checkpoint_path checkpoint --id rfnet

  # files-free smoke run on the CPU
  python -m recurrent_fusion_network_torch.main --device cpu \\
      --feature_type synthetic --batch_size 8 --max_iterations 3 \\
      --save_checkpoint_every 2 --val_images_use 8 --checkpoint_path /tmp/ck --id smoke

Multi-seed fleets (``--n_seeds``), meshes (``--num_dp_devices``,
``--num_mp_devices``, ``--async_opt``) are not ported and raise.
"""

from __future__ import annotations

from .config import parse_opt
from .data.build import build_loader
from .device import resolve_device
from .training.train_loop import train


def main(argv=None):
    """Parse ``argv`` (default: the command line), train, return the infos."""
    opt = parse_opt(argv)
    resolve_device(opt.device)  # no CUDA and no --device cpu: raise first
    loader = build_loader(opt, synthetic=bool(opt.synthetic_features))
    try:
        max_it = opt.max_iterations if opt.max_iterations > 0 else None
        return train(opt, loader, rank=0, max_iterations=max_it)
    finally:
        loader.close()


if __name__ == "__main__":
    main()
