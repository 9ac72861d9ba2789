"""The port's data loading vs the JAX package's, on the CPU.

The same files (a cocotalk-style JSON, npz labels, a top-words pickle and
feature stores), written to a temporary directory from a numpy seed, go
through both packages' ``Dataset.from_files``, ``DataLoader`` and
``build_loader``; every batch key must be equal bit for bit, across epoch
wraps, with the prefetch thread on and off and with augmentation-variant
draws.
"""

import json
import os
import pickle

import numpy as np
import pytest

from recurrent_fusion_network_torch import feat_registry as t_registry
from recurrent_fusion_network_torch.config import Options as TorchOptions
from recurrent_fusion_network_torch.data import build as t_build
from recurrent_fusion_network_torch.data import dataset as t_dataset
from recurrent_fusion_network_torch.data.loader import DataLoader as TorchLoader
from recurrent_fusion_network_tpu.config import Options as JaxOptions
from recurrent_fusion_network_tpu.data import build as j_build
from recurrent_fusion_network_tpu.data import dataset as j_dataset
from recurrent_fusion_network_tpu.data.loader import DataLoader as JaxLoader

N_TRAIN, N_VAL, N_TEST, L = 10, 4, 3, 6
WORDS = [f"w{i}" for i in range(1, 21)]
ENCODERS = ((6, 4, 3), (5, 2, 4))  # (fc_dim, att_num, att_dim)


def _write_corpus(root, seed=0):
    """cocotalk.json (with a restval image), labels npz with 3-6 captions per
    image, a top-words pickle. -> (json, labels, top-words) paths."""
    g = np.random.default_rng(seed)
    images, labels, starts, ends = [], [], [], []
    splits = (["train"] * (N_TRAIN - 1) + ["restval"] + ["val"] * N_VAL
              + ["test"] * N_TEST)
    for i, split in enumerate(splits):
        ncap = int(g.integers(3, 7))
        starts.append(len(labels) + 1)
        for _ in range(ncap):
            cap = np.zeros(L, np.int64)
            n = int(g.integers(2, L + 1))
            cap[:n] = g.integers(1, len(WORDS) + 1, n)
            labels.append(cap)
        ends.append(len(labels))
        images.append({"id": 500 + i, "split": split, "file_path": f"im/{500 + i}.jpg"})
    info = {"ix_to_word": {str(i + 1): w for i, w in enumerate(WORDS)}, "images": images}
    paths = [os.path.join(root, n) for n in ("cocotalk.json", "labels.npz", "top.pkl")]
    with open(paths[0], "w") as f:
        json.dump(info, f)
    np.savez(paths[1], labels=np.stack(labels), label_start_ix=np.array(starts),
             label_end_ix=np.array(ends))
    with open(paths[2], "wb") as f:
        pickle.dump({"words": WORDS[::2]}, f)
    return paths, [img["id"] for img in images]


def _write_features(root, ids, kind, seed=1):
    """One feature store per encoder of ENCODERS, every variant: the packed
    layout or the reference's per-image files. -> variant-dir maps (dir) or
    store roots (packed)."""
    g = np.random.default_rng(seed)
    out = []
    for e, (fc_d, a, d) in enumerate(ENCODERS):
        fcs = {v: g.standard_normal((len(ids), fc_d)).astype(np.float32)
               for v in t_registry.VARIANTS}
        atts = {v: g.standard_normal((len(ids), a, d)).astype(np.float32)
                for v in t_registry.VARIANTS}
        if kind == "packed":
            store = os.path.join(root, f"enc{e}", "packed")
            j_dataset.PackedFeatureSource.write(store, ids, fcs, atts)
            out.append(store)
            continue
        dirs = {}
        for v in t_registry.VARIANTS:
            dirs[v] = {k: os.path.join(root, f"enc{e}", v, k) for k in ("fc", "att")}
            for k in ("fc", "att"):
                os.makedirs(dirs[v][k])
            for r, image_id in enumerate(ids):
                np.save(os.path.join(dirs[v]["fc"], f"{image_id}.npy"), fcs[v][r])
                np.savez(os.path.join(dirs[v]["att"], f"{image_id}.npz"), feat=atts[v][r])
        out.append(dirs)
    return out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    paths, ids = _write_corpus(root)
    return root, paths, ids


def _sources(pkg, kind, stores):
    if kind == "synthetic":
        return [pkg.SyntheticFeatureSource(f, a, d, seed=3 + i)
                for i, (f, a, d) in enumerate(ENCODERS)]
    if kind == "packed":
        return [pkg.PackedFeatureSource(s) for s in stores]
    return [pkg.DirFeatureSource(s) for s in stores]


def _assert_batches_equal(a, b, where=""):
    assert set(a) == set(b), where
    for key in a:
        x, y = a[key], b[key]
        if key in ("fc_feats_array", "att_feats_array", "gts"):
            assert len(x) == len(y), (where, key)
            for u, v in zip(x, y):
                assert u.dtype == v.dtype and u.shape == v.shape, (where, key)
                np.testing.assert_array_equal(u, v, err_msg=f"{where} {key}")
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, (where, key)
            np.testing.assert_array_equal(x, y, err_msg=f"{where} {key}")
        else:
            assert x == y, (where, key)


def _opts(paths, **over):
    kw = dict(input_json=paths[0], input_label_h5=paths[1], top_words_path=paths[2],
              top_words_count=5, feature_type="feat_array", batch_size=4, seq_per_img=5,
              seed=11, feat_array_info=[{"fc_feat_size": f, "att_num": a, "att_feat_size": d}
                                        for f, a, d in ENCODERS])
    kw.update(over)
    return JaxOptions(**kw), TorchOptions(**kw, device="cpu")


def _loaders(paths, stores, kind, prefetch, **over):
    jopt, topt = _opts(paths, **over)
    jds = j_dataset.Dataset.from_files(*paths, top_words_count=5)
    tds = t_dataset.Dataset.from_files(*paths, top_words_count=5)
    return (JaxLoader(jopt, jds, _sources(j_dataset, kind, stores), prefetch=prefetch),
            TorchLoader(topt, tds, _sources(t_dataset, kind, stores), prefetch=prefetch))


def test_dataset_from_files_matches_jax(corpus):
    _, paths, ids = corpus
    j = j_dataset.Dataset.from_files(*paths, top_words_count=5)
    t = t_dataset.Dataset.from_files(*paths, top_words_count=5)
    assert t.ix_to_word == j.ix_to_word and t.top_words == j.top_words == WORDS[::2][:5]
    assert t.vocab_size == j.vocab_size and t.seq_length == j.seq_length == L
    np.testing.assert_array_equal(t.vocab_ix_to_top_ix, j.vocab_ix_to_top_ix)
    for kw in (dict(), dict(train_only=True), dict(online_training=True)):
        assert t.splits(**kw) == j.splits(**kw)
    for image_id in ids:
        np.testing.assert_array_equal(t.captions_for_image(image_id),
                                      j.captions_for_image(image_id))
    assert t_dataset.stable_feature_seed(7, "flip", 3) == j_dataset.stable_feature_seed(
        7, "flip", 3)


@pytest.mark.parametrize("kind, prefetch, use_flip, use_crop, keep", [
    ("synthetic", True, 0, 0, False), ("synthetic", False, 1, 1, False),
    ("packed", True, 1, 0, False), ("packed", False, 0, 0, False),
    ("dir", False, 1, 1, False), ("dir", True, 0, 0, False),
    ("packed", True, 1, 1, True), ("dir", False, 0, 0, True)])
def test_loader_batches_match_jax_across_epochs(corpus, tmp_path, kind, prefetch,
                                                use_flip, use_crop, keep):
    """Seven train batches of 4 over 10 images (two wraps and a reshuffle),
    then a val pass: every key bit-exact, the consumed-view state equal. The
    port assembles features in its staging ring (ordinary memory on the
    CPU): dropped batches give their slots back, and in the ``keep`` cases
    every batch is held to the end and must still be intact then (no slot
    is refilled under a live view)."""
    _, paths, ids = corpus
    stores = None if kind == "synthetic" else _write_features(str(tmp_path), ids, kind)
    jl, tl = _loaders(paths, stores, kind, prefetch, use_flip=use_flip, use_crop=use_crop)
    try:
        wraps, kept = 0, []
        for k in range(7):
            a, b = jl.get_batch("train"), tl.get_batch("train")
            _assert_batches_equal(a, b, f"train batch {k}")
            wraps += a["bounds"]["wrapped"]
            if keep:
                kept.append((a, b))
        assert wraps == 2
        for k, (a, b) in enumerate(kept):
            _assert_batches_equal(a, b, f"kept train batch {k}")
        assert tl.iterators == jl.iterators and tl.split_image_id == jl.split_image_id
        assert tl.rng_states == jl.rng_states
        for k in range(2):
            _assert_batches_equal(jl.get_batch("val"), tl.get_batch("val"), f"val {k}")
    finally:
        jl.close()
        tl.close()


def test_restore_state_and_reset_iterator_continue_as_jax(corpus):
    """A port loader restored from a mid-epoch snapshot (prefetch running
    ahead) continues on the uninterrupted JAX loader's batches; after a
    reset_iterator (cursor to 0, the random streams where the consumed
    batches left them) both give the same val batches again, from the
    split's first images."""
    _, paths, _ = corpus
    jl, tl = _loaders(paths, None, "synthetic", True, use_flip=1)
    _, tl2 = _loaders(paths, None, "synthetic", True, use_flip=1)
    try:
        for _ in range(2):
            jl.get_batch("train")
            tl.get_batch("train")
        snap = (dict(tl.iterators), {s: list(v) for s, v in tl.split_image_id.items()},
                dict(tl.rng_states))
        tl2.restore_state(*snap)
        for k in range(4):
            a = jl.get_batch("train")
            _assert_batches_equal(a, tl2.get_batch("train"), f"restored batch {k}")
            _assert_batches_equal(a, tl.get_batch("train"), f"continued batch {k}")
        first = jl.get_batch("val")
        _assert_batches_equal(first, tl.get_batch("val"), "val before reset")
        for loader in (jl, tl):
            loader.get_batch("val")
            loader.reset_iterator("val")
        again = jl.get_batch("val")
        _assert_batches_equal(again, tl.get_batch("val"), "val after reset")
        assert again["infos"] == first["infos"]
    finally:
        for loader in (jl, tl, tl2):
            loader.close()


def _registry_stores(root, ids):
    """Per-image files of the five registry encoders (original variant,
    tiny arrays: the dir source reads them as stored) and a native-geometry
    packed densenet store."""
    g = np.random.default_rng(5)
    for info in t_registry.feat_array_info(root):
        d = info.variant_dirs("original")
        for k in ("fc", "att"):
            os.makedirs(d[k])
        for image_id in ids:
            np.save(os.path.join(d["fc"], f"{image_id}.npy"),
                    g.standard_normal(4).astype(np.float32))
            np.savez(os.path.join(d["att"], f"{image_id}.npz"),
                     feat=g.standard_normal((2, 3)).astype(np.float32))
    dense = t_registry.densenet_info()
    packed = os.path.join(root, "densenet", "packed")
    j_dataset.PackedFeatureSource.write(
        packed, ids, {"original": g.standard_normal((len(ids), dense.fc_feat_size))},
        {"original": g.standard_normal((len(ids), dense.att_num, dense.att_feat_size))})


@pytest.mark.parametrize("feature_type", ["synthetic", "feat_array", "densenet", "resnet"])
def test_build_loader_matches_jax_for_each_feature_type(corpus, tmp_path, feature_type):
    """synthetic (one encoder, as both packages wire it for show_tell), the
    five-encoder registry array from per-image files, a packed single
    encoder at its registry geometry, a per-image-file single encoder."""
    _, paths, ids = corpus
    root = str(tmp_path)
    _registry_stores(root, ids)
    kw = dict(input_json=paths[0], input_label_h5=paths[1], top_words_path=paths[2],
              top_words_count=5, feature_type=feature_type, data_root=root, batch_size=3,
              seq_per_img=2, seed=4, caption_model="show_tell")
    jopt = JaxOptions(**kw)
    topt = TorchOptions(**kw, device="cpu")
    from recurrent_fusion_network_torch.config import finalize_options

    finalize_options(topt)
    assert len(topt.feat_array_info) == len(jopt.feat_array_info)
    jl = j_build.build_loader(jopt, prefetch=False)
    tl = t_build.build_loader(topt, prefetch=False)
    try:
        kinds = {type(s).__name__ for s in tl.sources}
        assert kinds == {type(s).__name__ for s in jl.sources}
        assert len(tl.sources) == (5 if feature_type == "feat_array" else 1)
        for k in range(4):
            _assert_batches_equal(jl.get_batch("train"), tl.get_batch("train"), f"batch {k}")
    finally:
        jl.close()
        tl.close()


def test_build_loader_refuses_a_sharded_store_and_a_wrong_geometry(corpus, tmp_path):
    """A sharded store at {data_root}/{encoder}/sharded/ (once refused) is
    read before a packed one, as the JAX package reads it: the batches of
    both loaders on it bit-exact, through the port's native gather. A
    sharded or packed store of another geometry than the registry's is
    refused."""
    from recurrent_fusion_network_torch.config import finalize_options
    from recurrent_fusion_network_torch.data.sharded import ShardedFeatureSource

    _, paths, ids = corpus
    root = str(tmp_path)
    kw = dict(input_json=paths[0], input_label_h5=paths[1], top_words_path=paths[2],
              top_words_count=5, data_root=root, caption_model="show_tell", batch_size=3,
              seq_per_img=2, seed=4)
    g = np.random.default_rng(6)
    v4 = t_registry.inception_v4_info()
    ShardedFeatureSource.write(
        os.path.join(root, "inception_v4", "sharded"), ids,
        {"original": g.standard_normal((len(ids), v4.fc_feat_size)).astype(np.float32)},
        {"original": g.standard_normal((len(ids), v4.att_num, v4.att_feat_size)
                                       ).astype(np.float32)}, shard_size=5)
    j_dataset.PackedFeatureSource.write(  # a packed store beside it is not read
        os.path.join(root, "inception_v4", "packed"), ids,
        {"original": np.zeros((len(ids), v4.fc_feat_size))},
        {"original": np.zeros((len(ids), v4.att_num, v4.att_feat_size))})
    topt = TorchOptions(feature_type="inception_v4", device="cpu", **kw)
    finalize_options(topt)
    jl = j_build.build_loader(JaxOptions(feature_type="inception_v4", **kw), prefetch=False)
    tl = t_build.build_loader(topt, prefetch=False)
    try:
        [src] = tl.sources
        assert type(src).__name__ == type(jl.sources[0]).__name__ == "ShardedFeatureSource"
        for k in range(4):
            _assert_batches_equal(jl.get_batch("train"), tl.get_batch("train"), f"batch {k}")
        assert src.engine == "native" and src.native_gathers > 0
    finally:
        jl.close()
        tl.close()
    for name, kind in (("resnet", "sharded"), ("densenet", "packed")):
        writer = (ShardedFeatureSource if kind == "sharded" else j_dataset.PackedFeatureSource)
        writer.write(os.path.join(root, name, kind), ids,
                     {"original": np.zeros((len(ids), 4), np.float32)},
                     {"original": np.zeros((len(ids), 2, 4), np.float32)})
        topt = TorchOptions(feature_type=name, device="cpu", **kw)
        finalize_options(topt)
        with pytest.raises(ValueError, match="registry declares"):
            t_build.build_loader(topt, prefetch=False)


def test_synthetic_setup_matches_jax():
    from recurrent_fusion_network_torch.data.synthetic import synthetic_setup as t_setup
    from recurrent_fusion_network_tpu.data.synthetic import synthetic_setup as j_setup

    jopt, jl = j_setup(batch_size=3, seq_per_img=2, seed=2)
    topt, tl = t_setup(batch_size=3, seq_per_img=2, seed=2, device="cpu")
    assert topt.feat_array_info == jopt.feat_array_info
    for k in range(6):
        _assert_batches_equal(jl.get_batch("train"), tl.get_batch("train"), f"batch {k}")
