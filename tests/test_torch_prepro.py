"""The port's data front vs the JAX package's, on the CPU: the runbook's
prepro stage (the prepro_labels and prepro_ngrams CLIs) and the sharded
feature store with its native gather.

Inputs are written from a numpy seed to a temporary directory; both
packages' CLIs and writers run on the same inputs. Everything is held
exactly: equal JSON, arrays, pickles and bytes, bit-exact feature rows
and loader batches.
"""

import filecmp
import json
import os
import pickle

import numpy as np
import pytest

from recurrent_fusion_network_torch import feat_registry as t_registry
from recurrent_fusion_network_torch.config import Options as TorchOptions
from recurrent_fusion_network_torch.data import dataset as t_dataset
from recurrent_fusion_network_torch.data import prepro_labels as t_labels
from recurrent_fusion_network_torch.data import prepro_ngrams as t_ngrams
from recurrent_fusion_network_torch.data import sharded as t_sharded
from recurrent_fusion_network_torch.data.loader import DataLoader as TorchLoader
from recurrent_fusion_network_tpu.data import dataset as j_dataset
from recurrent_fusion_network_tpu.data import prepro_labels as j_labels
from recurrent_fusion_network_tpu.data import prepro_ngrams as j_ngrams
from recurrent_fusion_network_tpu.data import sharded as j_sharded

from test_torch_data import _assert_batches_equal

WORDS = ["a", "the", "man", "dog", "red", "ball", "park", "is", "on", "with", "big",
         "small", "Sitting", "running"]
SPLITS = ["train"] * 7 + ["restval"] * 2 + ["val"] * 3 + ["test"] * 2


def _karpathy(root, seed=0):
    """A Karpathy-format dataset JSON: 14 images over the four splits, 2-4
    sentences each of 3-20 tokens (some longer than max_length, mixed case,
    an empty token) with and without 'raw', cocoid / imgid ids."""
    g = np.random.default_rng(seed)
    images = []
    for i, split in enumerate(SPLITS):
        sents = []
        for _ in range(int(g.integers(2, 5))):
            toks = [WORDS[k] for k in g.zipf(1.6, int(g.integers(3, 21))) % len(WORDS)]
            if g.random() < 0.2:
                toks.append(" ")
            sent = {"tokens": toks}
            if g.random() < 0.5:
                sent["raw"] = " ".join(toks).capitalize() + "."
            sents.append(sent)
        img = {"split": split, "filename": f"{i}.jpg", "sentences": sents}
        img.update({"filepath": "val2014", "cocoid": 900 + i} if i % 2 else {"imgid": i})
        images.append(img)
    path = os.path.join(root, "dataset_coco.json")
    with open(path, "w") as f:
        json.dump({"images": images, "dataset": "coco"}, f)
    return path


def _prepro(root, karpathy, pkg, labels_ext, *extra):
    """Run ``pkg``'s prepro_labels CLI into ``root`` -> its output paths."""
    os.makedirs(root, exist_ok=True)
    out = {k: os.path.join(root, n) for k, n in (
        ("json", "cocotalk.json"), ("labels", f"cocotalk_label{labels_ext}"),
        ("top", "vocab_train.pkl"))}
    pkg.main(["--input_json", karpathy, "--output_json", out["json"], "--output_labels",
              out["labels"], "--output_top_words", out["top"], *extra])
    return out


def _read_labels(path):
    if path.endswith(".h5"):
        import h5py

        with h5py.File(path, "r") as h5:
            return {k: h5[k][:] for k in ("labels", "label_start_ix", "label_end_ix")}
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("labels_ext, extra", [
    (".npz", ()), (".npz", ("--word_count_threshold", "1", "--max_length", "9")),
    (".h5", ("--top_words_count", "5"))])
def test_prepro_labels_cli_writes_what_the_jax_cli_writes(tmp_path, capsys, labels_ext,
                                                         extra):
    """Equal info JSON (vocabulary order, UNK, raw sentences, ids, splits,
    file paths), label arrays (values, dtypes, 1-based start / end) and
    top-words pickle; an empty caption raises in both."""
    karpathy = _karpathy(str(tmp_path))
    t = _prepro(str(tmp_path / "port"), karpathy, t_labels, labels_ext, *extra)
    j = _prepro(str(tmp_path / "jax"), karpathy, j_labels, labels_ext, *extra)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] and out[0].startswith("vocab=")
    with open(t["json"]) as a, open(j["json"]) as b:
        info = json.load(a)
        assert info == json.load(b)
    assert len(info["images"]) == len(SPLITS)
    assert ("UNK" in info["ix_to_word"].values()) == ("--word_count_threshold" not in extra)
    tl, jl = _read_labels(t["labels"]), _read_labels(j["labels"])
    assert sorted(tl) == sorted(jl)
    for k in tl:
        assert tl[k].dtype == jl[k].dtype
        np.testing.assert_array_equal(tl[k], jl[k], err_msg=k)
    with open(t["top"], "rb") as a, open(j["top"], "rb") as b:
        assert pickle.load(a) == pickle.load(b)
    with open(karpathy) as f:
        data = json.load(f)
    data["images"][3]["sentences"][0]["tokens"] = [" "]
    for pkg in (t_labels, j_labels):
        with pytest.raises(ValueError, match="empty caption"):
            pkg.preprocess(data)


@pytest.mark.parametrize("args", [("--karpathy_json",), ("--include_restval", "0"),
                                  ("--split", "all")])
def test_prepro_ngrams_cli_df_equals_the_jax_clis(tmp_path, capsys, args):
    """The df pickle the SCST CLI's --cider_df reads: equal n-gram table and
    ref_len, from the untruncated Karpathy tokens (--karpathy_json) or the
    label matrix, with and without restval and over every split."""
    karpathy = _karpathy(str(tmp_path), seed=1)
    files = _prepro(str(tmp_path), karpathy, t_labels, ".npz", "--max_length", "7")
    extra = ["--karpathy_json", karpathy] if args == ("--karpathy_json",) else list(args)
    pickles = {}
    for name, pkg in (("port", t_ngrams), ("jax", j_ngrams)):
        pickles[name] = os.path.join(str(tmp_path), f"{name}-df.p")
        pkg.main(["--input_json", files["json"], "--input_labels", files["labels"],
                  "--output_pkl", pickles[name], *extra])
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == out[-2]
    with open(pickles["port"], "rb") as a, open(pickles["jax"], "rb") as b:
        t, j = pickle.load(a), pickle.load(b)
    assert t == j and len(t["document_frequency"]) > 50
    assert all(type(k) is tuple and all(type(x) is int for x in k)
               for k in t["document_frequency"])


# ------------------------------------------------------- the sharded store

ENCODER = (6, 4, 3)  # fc_dim, att_num, att_dim
VARIANTS = ("original", "flip", "crop_tl")


def _arrays(n, seed=2, variants=VARIANTS):
    g = np.random.default_rng(seed)
    fc_d, a, d = ENCODER
    return ({v: g.standard_normal((n, fc_d)).astype(np.float32) for v in variants},
            {v: g.standard_normal((n, a, d)).astype(np.float32) for v in variants})


def _same_tree(a, b):
    cmp = filecmp.dircmp(a, b)
    assert not (cmp.left_only or cmp.right_only or cmp.diff_files or cmp.funny_files)
    _, mismatch, errors = filecmp.cmpfiles(a, b, cmp.common_files, shallow=False)
    assert not mismatch and not errors
    return cmp.common_files


def test_sharded_store_bytes_equal_the_jax_writers(tmp_path):
    """write (string and int ids, a last shard shorter than the others) and
    pack_to_shards from a packed store: the same files, byte for byte."""
    ids = [f"img{i}" for i in range(11)]
    fcs, atts = _arrays(len(ids))
    t_sharded.ShardedFeatureSource.write(str(tmp_path / "t"), ids, fcs, atts, shard_size=4)
    j_sharded.ShardedFeatureSource.write(str(tmp_path / "j"), ids, fcs, atts, shard_size=4)
    files = _same_tree(str(tmp_path / "t"), str(tmp_path / "j"))
    assert sorted(files) == ["manifest.json"] + [f"shard-0000{s}.bin" for s in range(3)]
    packed = str(tmp_path / "packed")
    j_dataset.PackedFeatureSource.write(packed, list(range(100, 113)), *_arrays(13, seed=3))
    t_sharded.pack_to_shards(packed, str(tmp_path / "tp"), shard_size=5)
    j_sharded.pack_to_shards(packed, str(tmp_path / "jp"), shard_size=5)
    assert len(_same_tree(str(tmp_path / "tp"), str(tmp_path / "jp"))) == 4


@pytest.mark.parametrize("engine", ["native", "memmap"])
def test_load_batch_equals_the_jax_readers_and_opens_only_the_touched_shards(tmp_path,
                                                                           engine):
    """load_batch over rows of two of four shards in mixed variants (a row
    twice), and load: equal to the JAX reader's rows bit for bit, through
    the native gather or numpy memory maps as asked; two shards opened."""
    ids = list(range(200, 214))
    fcs, atts = _arrays(len(ids))
    root = str(tmp_path / "store")
    t_sharded.ShardedFeatureSource.write(root, ids, fcs, atts, shard_size=4)
    src = t_sharded.ShardedFeatureSource(root, use_native=engine == "native")
    ref = j_sharded.ShardedFeatureSource(root, use_native=False)
    assert src.engine == engine and src.shards_opened == 0
    want_ids = [201, 209, 203, 208, 201, 210]
    want_vars = ["flip", "original", "crop_tl", "flip", "original", "crop_tl"]
    got = src.load_batch(want_ids, want_vars)
    want = ref.load_batch(want_ids, want_vars)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    r = ids.index(209)
    np.testing.assert_array_equal(got[1][1], atts["original"][r])
    assert src.shards_opened == 2
    assert src.native_gathers == (2 * 6 if engine == "native" else 0)  # 6 (shard, variant)s
    for a, b in zip(src.load(213, "flip"), ref.load(213, "flip")):
        np.testing.assert_array_equal(a, b)
    assert src.shards_opened == 3


def test_layout_mismatches_raise(tmp_path):
    ids = list(range(9))
    fcs, atts = _arrays(len(ids))
    root = str(tmp_path / "store")
    src = t_sharded.ShardedFeatureSource.write(root, ids, fcs, atts, shard_size=4)
    with pytest.raises(ValueError, match="variants for"):
        src.load_batch([1, 2], ["original"])
    with open(os.path.join(root, "manifest.json")) as f:
        manifest = json.load(f)
    for change, match in ((dict(version=2), "version"),
                          (dict(shard_size=3), "inconsistent manifest"),
                          (dict(ids=ids[:-1]), "inconsistent manifest")):
        with open(os.path.join(root, "manifest.json"), "w") as f:
            json.dump({**manifest, **change}, f)
        with pytest.raises(ValueError, match=match):
            t_sharded.ShardedFeatureSource(root)
    write = t_sharded.ShardedFeatureSource.write
    with pytest.raises(ValueError, match="variant sets differ"):
        write(str(tmp_path / "a"), ids, fcs, {"original": atts["original"]})
    with pytest.raises(ValueError, match="len\\(ids\\)"):
        write(str(tmp_path / "b"), ids[:-1], fcs, atts)
    bad = dict(atts, flip=atts["flip"][:, :, :2])
    with pytest.raises(ValueError, match="variant 'flip' rows"):
        write(str(tmp_path / "c"), ids, fcs, bad)


@pytest.mark.parametrize("prefetch", [True, False])
def test_loader_batches_from_a_sharded_store_equal_the_packed_stores(tmp_path, prefetch):
    """Two encoders' packed stores (every augmentation variant) and the
    sharded stores pack_to_shards makes of them: seven train batches with
    flip and crop draws, then a val batch, bit-exact; the sharded rows come
    through the native gather, one batched gather per encoder and batch."""
    from test_torch_data import ENCODERS, _write_corpus, _write_features

    paths, ids = _write_corpus(str(tmp_path))
    packed = _write_features(str(tmp_path), ids, "packed")
    sharded = [t_sharded.pack_to_shards(p, p.replace("packed", "sharded"), shard_size=4)
               for p in packed]
    opt = TorchOptions(
        input_json=paths[0], input_label_h5=paths[1], top_words_path=paths[2],
        top_words_count=5, feature_type="feat_array", batch_size=4, seq_per_img=5, seed=11,
        use_flip=1, use_crop=1, device="cpu",
        feat_array_info=[{"fc_feat_size": f, "att_num": a, "att_feat_size": d}
                         for f, a, d in ENCODERS])
    loaders = [TorchLoader(opt, t_dataset.Dataset.from_files(*paths, top_words_count=5),
                           sources, prefetch=prefetch)
               for sources in ([t_dataset.PackedFeatureSource(p) for p in packed], sharded)]
    try:
        for k in range(7):
            _assert_batches_equal(*(ld.get_batch("train") for ld in loaders), f"batch {k}")
        _assert_batches_equal(*(ld.get_batch("val") for ld in loaders), "val")
    finally:
        for ld in loaders:
            ld.close()
    assert all(s.engine == "native" and s.native_gathers >= 2 * 8 for s in sharded)
    assert t_registry.VARIANTS[1] == "flip"


def test_without_a_compiler_the_store_reads_through_memory_maps(tmp_path, monkeypatch):
    """No C++ compiler: the store warns and reads through numpy memory maps
    (the same rows); asked for the library, the loader raises."""
    from recurrent_fusion_network_torch.data import native
    from recurrent_fusion_network_torch.utils import native_build

    ids = list(range(6))
    fcs, atts = _arrays(len(ids))
    root = str(tmp_path / "store")
    t_sharded.ShardedFeatureSource.write(root, ids, fcs, atts, shard_size=4)
    monkeypatch.setattr(native.LIBRARY, "_lib", None)
    monkeypatch.setattr(native.LIBRARY, "fresh", lambda: False)
    monkeypatch.setattr(native_build, "compiler", lambda: None)
    with pytest.warns(UserWarning, match="memory maps"):
        src = t_sharded.ShardedFeatureSource(root)
    assert src.engine == "memmap"
    np.testing.assert_array_equal(src.load_batch([5, 0])[1], atts["original"][[5, 0]])
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.load_library(required=True)
    assert native.LIBRARY.path.parent.name == "native"
    assert native.LIBRARY.path.parents[1].name == "build"
