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

``--n_seeds N`` trains a fleet of N seeds in one process
(``training/multi_seed.py``), its per-seed triples under ranks 0..N-1.

Data parallelism (``parallel/``): ``--num_dp_devices D`` (or ``--async_opt
1``, the reference's Hogwild processes, mapped as the JAX CLI maps it:
``config.dp_devices``) starts D local ranks, one process per card (D gloo
ranks under ``--device cpu``), each training on its block of every global
batch with the gradients averaged over the ranks; with ``--n_seeds S`` the
ranks share out the fleet's seeds instead. Under a launcher's environment
(``python -m torch.distributed.run --nproc_per_node D -m
recurrent_fusion_network_torch.main --num_dp_devices D ...``, one or
several hosts) each process is one rank, and D must be the launcher's
world size. ``--num_mp_devices M`` (solo XE only, as in the JAX CLI)
lays the D x M ranks out as a dp x mp mesh (``parallel/mesh.py``): the
vocabulary-wide logit and embedding split over the M ranks of each dp
index, the batch over the D dp indices; D x M must then be the launcher's
world size.
"""

from __future__ import annotations

import sys

from .config import dp_devices, parse_opt
from .data.build import build_loader
from .device import resolve_device
from .parallel import distributed
from .parallel.mesh import MP_FLEET, make_mesh, make_mesh_2d
from .training.multi_seed import train_multi_seed
from .training.train_loop import train


def spawn_ranks(opt, n: int, entry, argv) -> None:
    """Run ``entry(argv)`` as ``n`` local ranks (``distributed.spawn_local``);
    on CUDA the kernels are built first, once, in this process."""
    if opt.device != "cpu":
        from .kernels.build import build_stale

        build_stale()
    distributed.spawn_local(n, entry, list(argv))


def join_group(opt, world: int):
    """This launched process as one rank of ``world``: -> its mesh, dp x mp
    under --num_mp_devices > 1, on ``opt.device`` (NCCL on CUDA, gloo on
    the CPU)."""
    mp = opt.num_mp_devices
    distributed.initialize(device=opt.device, mp=mp)
    return make_mesh_2d(world // mp, mp) if mp > 1 else make_mesh(world)


def main(argv=None):
    """Parse ``argv`` (default: the command line), train; returns the
    infos (a fleet's result dict under ``--n_seeds`` > 1), or None where it
    started the data-parallel ranks."""
    argv = sys.argv[1:] if argv is None else list(argv)
    opt = parse_opt(argv)
    if opt.num_mp_devices > 1 and opt.n_seeds > 1:  # JAX main.py:53-56
        raise ValueError(MP_FLEET)
    resolve_device(opt.device)  # no CUDA and no --device cpu: raise first
    world = dp_devices(opt)
    if world > 1 and not distributed.launched():
        spawn_ranks(opt, world, main, argv)
        return None
    mesh = join_group(opt, world) if distributed.launched() else None
    try:
        loader = build_loader(opt, synthetic=bool(opt.synthetic_features))
        try:
            max_it = opt.max_iterations if opt.max_iterations > 0 else None
            if opt.n_seeds > 1:
                return train_multi_seed(opt, loader, opt.n_seeds, max_iterations=max_it,
                                        mesh=mesh)
            return train(opt, loader, rank=0, max_iterations=max_it, mesh=mesh)
        finally:
            loader.close()
    finally:
        if mesh is not None:
            distributed.shutdown()


if __name__ == "__main__":
    main()
