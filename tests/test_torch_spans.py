"""The program's spans and counter (``utils/profiling.py``) in a tiny
``train``, ``train_rl`` and ``CaptionServer`` on the CPU: each records its
spans once per step, iteration or batch, and the numerics are the same
whether a profiler records the spans as ranges or not. (The copy's spans
and counter, ``pinned.*`` and ``h2d_bytes``, need the card:
``tests/test_torch_pinned.py``.)"""

import numpy as np
import pytest
import torch

from recurrent_fusion_network_torch.data.prepro_ngrams import compute_doc_freq
from recurrent_fusion_network_torch.data.synthetic import synthetic_setup
from recurrent_fusion_network_torch.decoding.serve import CaptionServer
from recurrent_fusion_network_torch.rewards.cider_d import CiderD
from recurrent_fusion_network_torch.training.train_loop import train
from recurrent_fusion_network_torch.training.train_rl_loop import train_rl
from recurrent_fusion_network_torch.utils import profiling

torch.set_num_threads(1)
STEPS = 4


def quiet(*_):
    pass


def _counts():
    return {name: agg.count for name, agg in profiling.aggregates().items()}


def _run(loop, tmp, profiled):
    """(the loop's result, its spans' counts, whether every record of the
    loop's thread read on) of one run from a fresh tracer."""
    opt, loader = synthetic_setup(batch_size=4, seq_per_img=2, prefetch=True, seed=3,
                                  device="cpu", losses_log_every=1,
                                  save_checkpoint_every=10 ** 6,
                                  checkpoint_path=str(tmp / f"ck{int(profiled)}"))
    profiling.reset()
    try:
        if profiled:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                out = loop(opt, loader)
        else:
            out = loop(opt, loader)
    finally:
        loader.close()
    aggs = profiling.aggregates()
    main = [r.on for name, a in aggs.items() if name not in ("loader.fill", "gc")
            for r in a.records]
    return out, _counts(), main


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _assert_same_numerics(a, b, keys):
    for k in keys:
        assert a[k] == b[k], k
    pa, pb = list(_leaves(a["final_params"])), list(_leaves(b["final_params"]))
    assert len(pa) == len(pb) > 0
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))


def test_train_records_its_spans_once_a_step(tmp_path):
    def loop(opt, loader):
        return train(opt, loader, max_iterations=STEPS, log_fn=quiet)

    plain, counts, main = _run(loop, tmp_path, False)
    traced, traced_counts, traced_main = _run(loop, tmp_path, True)
    for c in (counts, traced_counts):
        assert c["train.dispatch"] == c["train.loss_read"] == c["loader.wait"] == STEPS
        assert c["loader.fill"] >= STEPS
        assert not {"pinned.copy", "pinned.pin", "h2d_bytes"} & set(c)  # the CPU copies nothing
    assert not any(main) and all(traced_main)
    _assert_same_numerics(plain, traced, ["loss_history", "iter"])


def test_train_rl_records_its_spans_once_an_iteration(tmp_path):
    def loop(opt, loader):
        ids = loader.split_image_id["train"]
        scorer = CiderD(compute_doc_freq(loader.dataset, ids), float(np.log(len(ids))))
        assert scorer.engine == "native"
        return train_rl(opt, loader, scorer, max_iterations=STEPS, log_fn=quiet)

    plain, counts, main = _run(loop, tmp_path, False)
    traced, traced_counts, traced_main = _run(loop, tmp_path, True)
    names = ("rl.rollout", "rl.rollout_read", "rl.dispatch", "reward.prep", "reward.native",
             "loader.wait")
    for c in (counts, traced_counts):
        assert [c[n] for n in names] == [STEPS] * len(names), c
    assert not any(main) and all(traced_main)
    _assert_same_numerics(plain, traced, ["loss_history", "train_loss_history", "iter"])


def test_caption_server_records_each_request_and_batch():
    def decode(fcs, atts):
        return {"s": fcs[0].sum(dim=1) + atts[0].sum(dim=(1, 2))}

    profiling.reset()
    srv = CaptionServer(decode, 4, device="cpu")
    try:
        futs = [srv.submit([np.full(3, i, np.float32)], [np.ones((2, 5), np.float32)])
                for i in range(10)]
        rows = [f.result(timeout=30)["s"] for f in futs]
    finally:
        srv.close()
    assert rows == [pytest.approx(3 * i + 10) for i in range(10)]
    c = _counts()
    assert c["serve.submit"] == 10
    assert c["serve.gather"] == c["serve.assemble"] == srv.stats["batches"] >= 3
