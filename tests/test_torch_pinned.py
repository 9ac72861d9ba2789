"""The batch copy of the train loops (``data/pinned.py::device_batch``) and
the loader's staging ring. The card's tests import no JAX, so they run on a
machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_pinned.py -q

The ``cuda`` tests skip without a CUDA device (page-locked memory needs
one)."""

import sys

import numpy as np
import pytest
import torch

from recurrent_fusion_network_torch.data import pinned
from recurrent_fusion_network_torch.data.synthetic import synthetic_setup

torch.set_num_threads(1)


def _loader(prefetch, device="cpu"):
    return synthetic_setup(batch_size=3, seq_per_img=2, prefetch=prefetch, seed=1,
                           device=device)[1]


def _host(data):
    return (list(data["fc_feats_array"]) + list(data["att_feats_array"])
            + [data["labels"], data["masks"], data["top_words"]])


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_device_batch_on_the_cpu_keeps_the_arrays(dtype):
    data = _loader(False).get_batch("train")
    fc, att, labels, masks, top = pinned.device_batch(data, "cpu", dtype)
    got = fc + att + [labels, masks, top]
    for i, (t, a) in enumerate(zip(got, _host(data))):
        want = torch.from_numpy(a)
        if dtype is not None and i < len(fc) + len(att):  # features only
            want = want.to(dtype)
        assert t.dtype == want.dtype and torch.equal(t, want)
    # the arrays themselves, not copies, when no cast is asked for
    assert dtype is not None or fc[0].data_ptr() == data["fc_feats_array"][0].ctypes.data
    single = {"fc_feats": data["fc_feats_array"][0], "att_feats": data["att_feats_array"][0],
              "labels": data["labels"], "masks": data["masks"], "top_words": data["top_words"]}
    fc1, att1, *_ = pinned.device_batch(single, "cpu")
    assert len(fc1) == len(att1) == 1
    assert torch.equal(fc1[0], torch.from_numpy(data["fc_feats_array"][0]))


def test_unstaged_arrays_are_not_taken_for_staged_ones():
    a = np.zeros((3, 4), np.float32)
    assert pinned.staged(a) is None and pinned.staged([1, 2]) is None


def test_staging_ring_under_thread_switches_gives_the_unstaged_batches():
    """Stress: the prefetch thread, the fill pool and the views' finalizers
    share the ring's slots (in ordinary memory here) while the consumer
    drops each batch; with a very short switch interval every batch must
    still equal the JAX package's loader's, which assembles fresh arrays (a
    slot refilled under a live view would not)."""
    from recurrent_fusion_network_tpu.data.synthetic import synthetic_setup as j_setup

    plain = j_setup(batch_size=3, seq_per_img=2, prefetch=False, seed=1)[1]
    staged = _loader(True)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for k in range(60):
            ref, data = plain.get_batch("train"), staged.get_batch("train")
            for a, b in zip(_host(ref), _host(data)):
                np.testing.assert_array_equal(a, b, err_msg=f"batch {k}")
    finally:
        sys.setswitchinterval(interval)
        threads = [p.thread for p in staged._prefetchers.values()]
        staged.close()
        plain.close()
    assert threads and not any(t.is_alive() for t in threads)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (page-locked memory and streams)")


@pytest.mark.cuda
@pytest.mark.parametrize("prefetch", [True, False])
def test_pinned_staging_gives_the_unstaged_batches_on_the_card(cuda, prefetch,
                                                               monkeypatch):
    """A CUDA loader with a ring of 2 page-locked slots, copied on the side
    stream behind a long queued matmul, gives the batches of a CPU loader
    (ordinary memory, never copied): no slot is refilled before its copy
    has run, and the compute stream waits for the copy."""
    monkeypatch.setattr(pinned, "SLOTS", 2)
    plain, staged = _loader(False), _loader(prefetch, device="cuda")
    big = torch.randn(4096, 4096, device="cuda")
    try:
        for k in range(12):
            ref = plain.get_batch("train")
            data = staged.get_batch("train")
            for a in data["fc_feats_array"] + data["att_feats_array"]:
                hit = pinned.staged(a)
                assert hit is not None and hit[1].is_pinned()
            for _ in range(3):
                big = big @ big / 64.0  # keeps the compute stream busy
            out = pinned.device_batch(data, "cuda")
            got = out[0] + out[1] + list(out[2:])
            sums = [t.double().sum() for t in got]  # on the compute stream
            for s, a in zip(sums, _host(ref)):
                assert float(s) == pytest.approx(float(a.astype(np.float64).sum()),
                                                 rel=1e-12), k
    finally:
        staged.close()
        plain.close()


@pytest.mark.cuda
def test_device_batch_pins_unstaged_arrays_and_does_not_wait(cuda):
    data = _loader(False).get_batch("train")
    copier = pinned.copier("cuda")
    copier.timing, copier.timings, copier.host_ms = True, [], []
    try:
        fc, att, labels, masks, top = pinned.device_batch(data, "cuda", torch.bfloat16)
        assert fc[0].dtype == torch.bfloat16 and labels.dtype == torch.int64
        torch.testing.assert_close(fc[0].float().cpu(),
                                   torch.from_numpy(data["fc_feats_array"][0]).bfloat16().float())
        assert torch.equal(top.cpu(), torch.from_numpy(data["top_words"]))
        [(start, done)] = copier.timings
        done.synchronize()
        assert start.elapsed_time(done) >= 0.0 and len(copier.host_ms) == 1
    finally:
        copier.timing = False
