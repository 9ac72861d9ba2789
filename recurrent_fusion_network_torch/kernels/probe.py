"""Probe of what each design step of the additive-attention kernels buys,
and of what limits their passes, in bf16.

Run on a machine with one CUDA card, from the checkout root:

    python -m recurrent_fusion_network_torch.kernels.probe

For each variant it copies ``csrc/`` into ``build/probe/<variant>/`` with a
few text edits, builds the copy with the flags of ``kernels/build.py``, and
times the kernels through the package's own wrappers (with the variant's
launch layout where it changes one) at flagship shapes in bf16: stage I
encoders 0 and 1 and the train-step decoder (512 rows, H = 512), with the
device time of ``torch.profiler``. The package's sources and launch plan
stay as they are: the variants exist only in ``build/`` (which
``.gitignore`` lists) and only while this runs.

Each variant undoes one design step, or keeps one pass:
  scalar_path         every launch on the kernels' scalar path (element
                      copies by the producer warp, scalar reads and writes)
                      instead of 16-byte bulk copies and vector access;
  ring_4_stages_of_8kb  a ring of 4 stages of about 8 KB per row instead of
                      2 of about 16 KB (stage I; the same bytes in flight);
  no_overlap          the producer issues the second pass's first stages only
                      after the first pass has released every stage;
  one_row_per_block   one row per block (8 warps) at A <= 8, not 4 rows;
  tanhf               bf16 tanh by tanhf instead of tanh.approx.f32;
  plain_f32_layout    q, v, dz copies in plain order (2-way bank conflicts);
  serial_row_loads    q, v, dz loaded without unrolling;
  keys_only[_tanhf]   only the keys pass (the producer streams only keys;
                      the values-dependent outputs are garbage);
  keys_only_no_dkeys_bwd  the backward's keys pass without its dkeys stores;
  values_only         only the values pass.
A variant's bound is the bytes it still moves over 3.35 TB/s.

Beside the variants it reports, for the sources as built, the backward's
device time split between its two kernels (the row kernel and the kernel
that reduces dv and dbv over a head group) at each site, and two yardsticks
of the card's memory system: a device-to-device copy of a stage-I key tensor
(what the backward's keys pass moves: read once, written once) and a
read-only sum over a stage-I value tensor.

Prints one JSON object per variant, site and direction, per site of the
split, per yardstick, and a summary line.
"""

from __future__ import annotations

import json
import shutil
import statistics
import sys
from pathlib import Path

import torch

from . import additive_attention as aa
from . import build

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
CSRC = build.CSRC  # the package's sources, copied into each variant
HID, ROWS = 512, 512
SITES = (("stage1_enc0", 196, 2048), ("stage1_enc1", 64, 1536), ("decoder", 8, 512))

_TANH_APPROX = ('  float y;\n  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));\n'
                '  return y;')
_FWD_KEYS_ONLY = [  # the producer stops after segment 0 (keys); no values pass
    ("common.cuh", "const int C = C0 + (A + P1 - 1) / P1;", "const int C = C0;"),
    ("additive_attention.cu", "const int Cv = (A + Pv - 1) / Pv;", "const int Cv = 0;"),
]
_BWD_KEYS_ONLY = [  # the producer skips segment 0 (values); no values pass
    ("common.cuh", "const int C0 = (A + P0 - 1) / P0;", "const int C0 = 0;"),
    ("additive_attention_bwd.cu", "const int Cv = (A + Pv - 1) / Pv;", "const int Cv = 0;"),
]
_FWD_VALUES_ONLY = [  # the producer skips segment 0 (keys); no keys pass
    ("common.cuh", "const int C0 = (A + P0 - 1) / P0;", "const int C0 = 0;"),
    ("additive_attention.cu", "const int Ck = (A + Pk - 1) / Pk;", "const int Ck = 0;"),
]
_BWD_VALUES_ONLY = [  # the producer stops after segment 0 (values); no keys pass
    ("common.cuh", "const int C = C0 + (A + P1 - 1) / P1;", "const int C = C0;"),
    ("additive_attention_bwd.cu", "const int Ck = (A + Pk - 1) / Pk;", "const int Ck = 0;"),
]
_NO_DKEYS = [  # the keys pass computes dkeys but does not store it
    ("additive_attention_bwd.cu", "store_vec<T, kVec>(dkr, j * V, H, x);", ""),
]
_TANHF = [("common.cuh", _TANH_APPROX, "  return tanhf(x);")]
_NO_OVERLAP = [(
    "common.cuh",
    "    for (int t = 0; t < r.R && row0 + t < rows; ++t) {\n      const T* src",
    "    if (i == C0)  // wait until every stage of segment 0 is released\n"
    "      for (int j = C0 > r.n_stages ? C0 - r.n_stages : 0; j < C0; ++j)\n"
    "        for (int t = 0; t < r.R && row0 + t < rows; ++t)\n"
    "          if (lane == 0) mbar_wait(r.empty(t, j % r.n_stages), (j / r.n_stages) & 1);\n"
    "    __syncwarp();\n"
    "    for (int t = 0; t < r.R && row0 + t < rows; ++t) {\n      const T* src")]
_PLAIN_LAYOUT = [("common.cuh", "return ((e & 4) ? pad8(n) / 2 : 0) + ((e >> 3) << 2) + (e & 3);",
                  "return e;")]
_SERIAL_LOADS = [("common.cuh",
                  "#pragma unroll 4\n    for (int j = tid; j < n / N; j += threads) {",
                  "#pragma unroll 1\n    for (int j = tid; j < n / N; j += threads) {")]
_BOTH = ("fwd", "bwd")

# name -> (directions it times, edits, launch-layout overrides)
VARIANTS = {
    "as_built": (_BOTH, [], {}),
    "scalar_path": (_BOTH, [], {"vec": 0}),
    "ring_4_stages_of_8kb": (_BOTH, [], {"stages": 4, "stage_target": 8192}),
    "no_overlap": (_BOTH, _NO_OVERLAP, {}),
    "one_row_per_block": (_BOTH, [], {"R": 1}),
    "tanhf": (_BOTH, _TANHF, {}),
    "plain_f32_layout": (_BOTH, _PLAIN_LAYOUT, {}),
    "serial_row_loads": (_BOTH, _SERIAL_LOADS, {}),
    "keys_only_fwd": (("fwd",), _FWD_KEYS_ONLY, {}),
    "keys_only_tanhf_fwd": (("fwd",), _FWD_KEYS_ONLY + _TANHF, {}),
    "keys_only_bwd": (("bwd",), _BWD_KEYS_ONLY, {}),
    "keys_only_tanhf_bwd": (("bwd",), _BWD_KEYS_ONLY + _TANHF, {}),
    "keys_only_no_dkeys_bwd": (("bwd",), _BWD_KEYS_ONLY + _NO_DKEYS, {}),
    "values_only_fwd": (("fwd",), _FWD_VALUES_ONLY, {}),
    "values_only_bwd": (("bwd",), _BWD_VALUES_ONLY, {}),
}


def overridden(plan, vec, over):
    """The wrappers' _plan and _vec with a variant's overrides: R rows per
    block at A <= 8; at A > 8 stages per row, each of about `stage_target`
    bytes of whole rows; the vector flag."""
    def new_plan(A, H, D, dtype, backward):
        R, stages, stage, smem = plan(A, H, D, dtype, backward)
        team_bytes = (smem - aa._RING_HEADER) // R - stages * stage  # f32 area of a row
        esize = torch.empty((), dtype=dtype).element_size()
        if A <= 8:
            R = over.get("R", R)
        else:
            stages = over.get("stages", stages)
            if "stage_target" in over:
                row = max(H, D) * esize
                per_stage = max(1, (over["stage_target"] + row // 2) // row)
                stage = -(-per_stage * row // 16) * 16
        if backward:  # the keys pass's last reduction reuses a row's stages
            threads = aa.CONSUMER_THREADS // R
            stage = max(stage, -(-2 * threads * (16 // esize) * 4 // (16 * stages)) * 16)
        return R, stages, stage, aa._RING_HEADER + R * (stages * stage + team_bytes)

    def new_vec(*args):
        return over["vec"] if "vec" in over else vec(*args)

    return new_plan, new_vec


def make_variant(name, edits, dest=None) -> Path:
    """<dest>/<name>/csrc (dest: build/probe): a copy of csrc/ with the
    edits applied."""
    root = (build.BUILD_DIR.parent / "probe" if dest is None else Path(dest)) / name
    csrc = root / "csrc"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(CSRC, csrc)
    for fname, old, new in edits:
        path = csrc / fname
        text = path.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"probe edit for {name} does not match {fname}: {old!r}")
        path.write_text(text.replace(old, new))
    return root


def use_sources(root: Path):
    """Point kernels/build.py at a variant's sources and libraries."""
    build.CSRC = root / "csrc"
    build.BUILD_DIR = root / "lib"
    build._libs.clear()


def device_ms_by_kernel(fn, input_sets, reps=20):
    """{device activity name: mean device time per call in ms} from
    torch.profiler (empty if it records no device activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*input_sets[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(*input_sets[i % len(input_sets)])
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.end - e.time_range.start
            out[e.name] = out.get(e.name, 0.0) + us / reps / 1e3
    return out


def device_ms(fn, input_sets, reps=20):
    """Mean device time per call from torch.profiler (None if it records no
    device activity)."""
    total = sum(device_ms_by_kernel(fn, input_sets, reps).values())
    return total if total > 0 else None


def kernel_split(data, rounds):
    """The backward's device time per call at each site, split between its
    row kernel and its group-reduction kernel (median over rounds)."""
    for name, A, D in SITES:
        sets = [s["bwd"] for s in data[name]]
        runs = [device_ms_by_kernel(
            lambda *x: aa.additive_attention_bwd(*x, need_dvalues=A <= 8), sets)
            for _ in range(rounds)]
        split = {}
        for part in ("bwd_rows", "bwd_groups"):
            split[part] = statistics.median(
                sum(ms for k, ms in run.items() if part in k) for run in runs)
        print(json.dumps({"split": "additive_attention_bwd", "site": name, "A": A, "D": D,
                          **{f"{k}_ms": v for k, v in split.items()}}), flush=True)


def yardsticks(rounds):
    """The card's rates for a copy (read + write) and a read-only sum of
    stage-I-sized bf16 tensors, in GB/s of bytes moved."""
    keys = torch.randn(ROWS, 196, HID, device="cuda").to(torch.bfloat16)
    dst = torch.empty_like(keys)
    values = torch.randn(ROWS, 196, 2048, device="cuda").to(torch.bfloat16)
    for name, fn, x, nbytes in (
            ("copy", lambda x: dst.copy_(x), keys, 2 * keys.numel() * 2),
            ("read_sum", lambda x: x.sum(dtype=torch.float32), values, values.numel() * 2)):
        ms = statistics.median(device_ms(fn, [(x,)]) for _ in range(rounds))
        print(json.dumps({"yardstick": name, "bytes": nbytes, "ms": ms,
                          "gb_per_s": nbytes / ms / 1e6,
                          "share_of_3350_gb_per_s": nbytes / ms / 1e6 / 3350}), flush=True)


def event_ms(fn, input_sets, reps=20, repeats=5):
    fn(*input_sets[0])
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(reps):
            fn(*input_sets[i % len(input_sets)])
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def inputs(gen, A, D, n_sets=4):
    def r(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    sets = []
    for _ in range(n_sets):
        q, keys, v, bv, values = (r(ROWS, HID), r(ROWS, A, HID), r(1, HID, scale=0.06),
                                  r(1, scale=0.06), r(ROWS, A, D))
        _, w = aa.additive_attention_ref(q, keys, v, bv, values)
        sets.append(dict(fwd=(q, keys, v, bv, values),
                         bwd=(r(ROWS, D), None, q, keys, v, values, w)))
    return sets


def compile_variants(roots):
    """Build every variant's two libraries at once (one nvcc each)."""
    import subprocess

    nvcc = build._nvcc()
    procs = []
    for root in roots:
        (root / "lib").mkdir(parents=True, exist_ok=True)
        for name in ("additive_attention", "additive_attention_bwd"):
            cmd = [nvcc, *build.NVCC_FLAGS, "-o", str(root / "lib" / f"lib{name}.so"),
                   str(root / "csrc" / f"{name}.cu")]
            procs.append((root, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    for root, proc in procs:
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {root}:\n{out}")


def main(rounds=3):
    if not torch.cuda.is_available():
        raise SystemExit("probe: CUDA is not available")
    gen = torch.Generator(device="cuda").manual_seed(11)
    data = {name: inputs(gen, A, D) for name, A, D in SITES}
    plan, vec = aa._plan, aa._vec
    roots = {v: make_variant(v, edits) for v, (_, edits, _) in VARIANTS.items()}
    compile_variants(roots.values())
    # rounds over all variants in turn, so that drift of the card's clocks
    # over the run does not favour one variant; each row keeps every round's
    # device time and reports the median
    times = {}
    for _ in range(rounds):
        for variant, (dirs, _, over) in VARIANTS.items():
            use_sources(roots[variant])
            aa._plan, aa._vec = overridden(plan, vec, over)
            for name, A, D in SITES:
                dvalues = A <= 8  # the decoder's values need a grad, stage I's do not
                fns = {"fwd": aa.additive_attention_fwd,
                       "bwd": lambda *x: aa.additive_attention_bwd(*x, need_dvalues=dvalues)}
                for d in dirs:
                    sets = [s[d] for s in data[name]]
                    ms = device_ms(fns[d], sets) or event_ms(fns[d], sets)
                    times.setdefault((variant, d, name, A, D), []).append(ms)
    aa._plan, aa._vec = plan, vec
    for (variant, d, name, A, D), ms_all in times.items():
        dvalues = A <= 8
        keys_bytes = ROWS * A * HID * 2
        values_bytes = ROWS * A * D * 2 * (2 if dvalues and d == "bwd" else 1)  # + dvalues
        rows_bytes = {"fwd": ROWS * (HID + D + A) * 2,      # q; z, w
                      "bwd": ROWS * (2 * HID + D + A) * 2}  # q, dz, w; dq
        if variant.startswith("values_only"):
            nbytes = values_bytes
        elif variant.startswith("keys_only"):
            nbytes = keys_bytes * (2 if d == "bwd" and "no_dkeys" not in variant else 1)
        else:
            nbytes = keys_bytes * (2 if d == "bwd" else 1) + values_bytes + rows_bytes[d]
        ms = statistics.median(ms_all)
        row = dict(variant=variant, dir=d, site=name, A=A, D=D, ms=ms, ms_rounds=ms_all,
                   bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                   gb_per_s=nbytes / ms / 1e6)
        row["bound_over_ms"] = row["bound_ms"] / ms
        print(json.dumps(row), flush=True)
    use_sources(roots["as_built"])
    kernel_split(data, rounds)
    yardsticks(rounds)
    print(json.dumps({"probe": "done", "rows": len(times), "rounds": rounds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
