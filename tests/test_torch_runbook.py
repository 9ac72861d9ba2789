"""The port's COCO runbook (recurrent_fusion_network_torch/scripts/run_coco.sh)
held as tests/test_runbook.py holds the JAX one: bash syntax, the encoder
table against the JAX runbook's and the port's registry, every stage gated.
Then shim runs: a ``python`` first on PATH records every command the
runbook issues (running the real interpreter only for the dry corpus's
heredoc), and each recorded command must be a module of the port, name
nothing of the JAX package and parse with that module's own parser.
"""

import importlib
import json
import os
import re
import stat
import subprocess
import sys
import uuid

import pytest

from recurrent_fusion_network_torch import feat_registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "recurrent_fusion_network_torch", "scripts")
SCRIPT = os.path.join(SCRIPTS, "run_coco.sh")
FLEET_SCRIPTS = ("train_recurrent_fusion_model.sh", "train_recurrent_fusion_model_rl.sh")
ROW = re.compile(r'^\s*"(\w+)\s+(\S+)\s+(\d+)\s+(\d+)\s+(\S+)"\s*$', re.M)
ROOT_CLIS = ("main.py", "main_rl.py", "eval.py", "eval_ensemble.py", "serve.py")
PORT = "recurrent_fusion_network_torch."


def _read(path):
    with open(path) as f:
        return f.read()


RECIPES = {"eval_single.sh": "eval", "eval_ensemble.sh": "eval_ensemble",
           "train_review_net.sh": "main", "train_review_net_rl.sh": "main_rl",
           "train_single_recurrent_fusion_model.sh": "main",
           "train_single_recurrent_fusion_model_rl.sh": "main_rl"}


@pytest.mark.parametrize("name", ("run_coco.sh",) + FLEET_SCRIPTS + tuple(sorted(RECIPES)))
def test_bash_syntax_and_pipefail(name):
    subprocess.run(["bash", "-n", os.path.join(SCRIPTS, name)], check=True, timeout=60)
    text = _read(os.path.join(SCRIPTS, name))
    assert "set -e\n" in text and "set -o pipefail" in text


def test_encoder_table_matches_the_jax_runbook_and_the_registry():
    """The same five rows as scripts/run_coco.sh; each grid squared is the
    port's registry att_num, at each arch's native geometry."""
    rows = ROW.findall(_read(SCRIPT))
    assert rows == ROW.findall(_read(os.path.join(REPO, "scripts", "run_coco.sh")))
    infos = feat_registry.feat_array_info()
    assert [r[0] for r in rows] == [i.name for i in infos]
    for (name, arch, att, imsz, _), info in zip(rows, infos):
        assert int(att) ** 2 == info.att_num, (name, att)
        if name in ("resnet", "densenet"):
            assert int(imsz) // 32 == int(att), (name, imsz, att)
        else:
            assert (int(imsz), int(att)) == (299, 8), (name, imsz)


def test_every_stage_gated_and_the_knobs_kept():
    text = _read(SCRIPT)
    for stage in ("prepro", "features", "xe", "rl", "eval"):
        assert f"has_stage {stage}" in text, stage
    for knob in ("STAGES", "DRY_RUN", "ID", "NUM_SEEDS", "DATA_DIR", "RESUME", "FLEET_DEVICES"):
        assert re.search(rf"^\s*(export )?{knob}=\$\{{{knob}:-", text, re.M), knob
    assert 'cd "$(dirname "$0")/../.."' in text
    assert "recurrent_fusion_network_tpu" not in text + "".join(
        _read(os.path.join(SCRIPTS, s)) for s in FLEET_SCRIPTS)


SHIM = """#!{python}
import json, os, sys
if sys.argv[1:2] == ["-"]:  # the dry corpus's heredoc: run it
    os.execv({python!r}, [{python!r}] + sys.argv[1:])
with open(os.environ["SHIM_LOG"], "a") as f:
    f.write(json.dumps(sys.argv[1:]) + "\\n")
"""


def _shim_run(tmp_path, run_id, triples=(), **env):
    """Run the runbook with a recording ``python`` first on PATH, after
    writing the (empty) ``triples`` under the repo's checkpoint/; -> (the
    recorded argvs, the run's stdout). Files under log/ and checkpoint/
    named by its ID are removed."""
    bindir = tmp_path / "bin"
    bindir.mkdir(exist_ok=True)
    shim = bindir / "python"
    shim.write_text(SHIM.format(python=sys.executable))
    shim.chmod(shim.stat().st_mode | stat.S_IEXEC)
    log = tmp_path / f"argv_{run_id}.jsonl"
    base = {k: v for k, v in os.environ.items() if k != "PYTHON"}
    base.update(PATH=f"{bindir}{os.pathsep}{os.environ['PATH']}", SHIM_LOG=str(log), ID=run_id)
    made = [d for d in ("log", "checkpoint") if not os.path.isdir(os.path.join(REPO, d))]
    try:
        for name in triples:
            os.makedirs(os.path.join(REPO, "checkpoint"), exist_ok=True)
            with open(os.path.join(REPO, "checkpoint", name), "wb"):
                pass
        r = subprocess.run(["bash", SCRIPT], env={**base, **env}, capture_output=True,
                           text=True, timeout=300)
    finally:
        for d in ("log", "checkpoint"):
            path = os.path.join(REPO, d)
            for name in os.listdir(path) if os.path.isdir(path) else ():
                if run_id in name:
                    os.remove(os.path.join(path, name))
            if d in made and os.path.isdir(path) and not os.listdir(path):
                os.rmdir(path)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    with open(log) as f:
        return [json.loads(line) for line in f], r.stdout


def _parse(argv):
    """Parse one recorded command with its module's own parser."""
    assert argv[0] == "-m" and argv[1].startswith(PORT), argv
    assert not any("recurrent_fusion_network_tpu" in a or a.endswith(ROOT_CLIS)
                   for a in argv), argv
    module = importlib.import_module(argv[1])
    parse = getattr(module, "parse_args", None) or module.parse_opt
    return argv[1][len(PORT):], parse(argv[2:])


def test_dry_run_issues_only_port_commands_that_parse(tmp_path):
    run_id = f"shim{uuid.uuid4().hex[:8]}"
    data = tmp_path / "data"
    calls, out = _shim_run(tmp_path, run_id, DRY_RUN="1", DATA_DIR=str(data))
    parsed = [_parse(argv) for argv in calls]
    names = [n for n, _ in parsed]
    assert names == (["data.prepro_labels", "data.prepro_ngrams"]
                     + ["data.feature_extraction.extract"] * 5
                     + ["main", "main_rl", "eval", "eval_ensemble"]), names
    # the dry corpus was written by the real interpreter
    karpathy = json.loads((data / "dry_dataset_coco.json").read_text())
    assert len(karpathy["images"]) == 8 and len(list((data / "dry_images").iterdir())) == 8
    args = dict(parsed)
    assert args["data.prepro_labels"].word_count_threshold == 1
    assert [a.arch for n, a in parsed if n.endswith("extract")] == [
        "resnet101", "inception_v4", "inception_v3", "densenet161", "inception_resnet_v2"]
    assert all(a.variants == "original" and a.batch_size == 2 and a.torch_weights is None
               for n, a in parsed if n.endswith("extract"))
    xe, (rl_pre, rl) = args["main"], args["main_rl"]
    for opt in (xe, rl):
        assert (opt.id, opt.n_seeds, opt.num_dp_devices, opt.max_iterations) == (run_id, 2, 1, 4)
        assert opt.caption_model == "recurrent_fusion_model" and opt.feature_type == "feat_array"
        assert opt.data_root == str(data / "features") and opt.batch_size == 2
        assert (opt.use_flip, opt.use_crop, opt.save_checkpoint_every) == (0, 0, 2)
    assert xe.start_from is None
    assert (rl.start_from, rl.load_model_id, rl.load_lr) == ("checkpoint", run_id, 1)
    assert rl_pre.cider_df == str(data / "coco-train-idxs.p")
    ev, (ens_pre, ens) = args["eval"], args["eval_ensemble"]
    assert (ev.load_model_id, ev.rl_prefix, ev.beam_size, ev.eval_split) == (
        run_id, 1, 3, "test")
    assert (ens_pre.model_ids, ens_pre.n_ranks, ens.rl_prefix, ens.dtype) == (
        run_id, 2, 1, "float32")
    assert "run_coco.sh: all requested stages" in out


def test_real_run_with_two_fleet_devices_raises_m10_and_resumes_pkl_triples(tmp_path):
    """FLEET_DEVICES=2 reaches --num_dp_devices 2, which the port's parsers
    take since the fleet over ranks was ported (it raised by name, M10,
    before): the XE and SCST stages run their 2 seeds over 2 ranks. A
    rolling .pkl XE triple turns the XE stage into a resume; a real run's
    ensemble eval reads its members in bf16."""
    run_id = f"shim{uuid.uuid4().hex[:8]}"
    calls, _ = _shim_run(tmp_path, run_id, [f"model_{run_id}_0.pkl"],
                         COCO_IMAGES=str(tmp_path), NUM_SEEDS="2",
                         KARPATHY_JSON=str(tmp_path / "k.json"), FLEET_DEVICES="2",
                         DATA_DIR=str(tmp_path / "data"), STAGES="xe,rl,eval")
    assert [argv[1] for argv in calls] == [PORT + m for m in
                                           ("main", "main_rl", "eval", "eval_ensemble")]
    for argv in calls[:2]:
        i = argv.index("--num_dp_devices")
        assert argv[i + 1] == "2"
        name, parsed = _parse(argv)
        opt = parsed if name == "main" else parsed[1]
        assert (opt.num_dp_devices, opt.n_seeds) == (2, 2)
    xe = calls[0]
    i = xe.index("--start_from")
    assert xe[i + 1:i + 4] == ["checkpoint", "--load_model_id", run_id]
    _, (_, ens) = _parse(calls[3])
    assert ens.dtype == "bfloat16"


# ------------------------------------------------ the recipes beside the runbook

RECORDER = """#!{python}
import json, os, sys
with open(os.environ["SHIM_LOG"], "a") as f:
    f.write(json.dumps(sys.argv[1:]) + "\\n")
"""
# each root CLI's own flags, parsed before parse_opt (eval.py:74-79,
# eval_ensemble.py:26-37, main_rl.py:20-22)
ROOT_PRE = {"eval": (("--rl_prefix", int, 0), ("--rank", int, 0)),
            "eval_ensemble": (("--model_ids", str, None), ("--n_ranks", int, 1),
                              ("--rl_prefix", int, 0), ("--diff_feat", int, 0)),
            "main": (), "main_rl": (("--cider_df", str, "data/coco-train-idxs.p"),)}
RECIPE_ENV = {"ID": "r7", "SEED": "3", "FEATURE": "resnet", "SPLIT": "val", "BEAM": "2",
              "MODEL_IDS": "a,b:1", "RL": "0", "FLIP": "1"}


def _recorded(tmp, script, cwd, env):
    """The one command ``script`` issues, run with a recording interpreter
    as ``python`` on PATH and as $PYTHON."""
    bindir = tmp / "bin"
    bindir.mkdir(exist_ok=True)
    shim = bindir / "python"
    shim.write_text(RECORDER.format(python=sys.executable))
    shim.chmod(shim.stat().st_mode | stat.S_IEXEC)
    log = tmp / f"argv_{uuid.uuid4().hex[:8]}.jsonl"
    cwd.mkdir()
    base = {k: v for k, v in os.environ.items() if k not in RECIPE_ENV}
    subprocess.run(["bash", script], cwd=cwd, check=True, timeout=120,
                   env={**base, **env, "PATH": f"{bindir}{os.pathsep}{os.environ['PATH']}",
                        "PYTHON": str(shim), "SHIM_LOG": str(log)})
    with open(log) as f:
        calls = [json.loads(line) for line in f]
    assert len(calls) == 1, calls
    return calls[0]


def _options(pre_flags, parse_opt, argv):
    """{flag: value} of one command: the CLI's own flags and parse_opt's."""
    import argparse

    pre = argparse.ArgumentParser(add_help=False)
    for flag, kind, default in pre_flags:
        pre.add_argument(flag, type=kind, default=default)
    pre_args, rest = pre.parse_known_args(argv)
    return {**vars(parse_opt(rest)), **vars(pre_args)}


def _comparable(value):
    if isinstance(value, (list, tuple)):
        return [_comparable(v) for v in value]
    if hasattr(value, "keys"):  # EncoderInfo of either package
        return {k: _comparable(value[k]) for k in value.keys()}
    return value


@pytest.mark.parametrize("env", ({}, RECIPE_ENV), ids=("defaults", "env"))
@pytest.mark.parametrize("name", sorted(RECIPES))
def test_recipe_parses_as_the_root_recipe(name, env, tmp_path):
    """The port's recipe issues its CLI as ``$PYTHON -m
    recurrent_fusion_network_torch.<cli>``; parsed by the port's parser
    (parse_opt, the CLIs' own flags) it gives every option the JAX parser
    gives the root recipe's command, with the same variables set."""
    from recurrent_fusion_network_torch import config as t_config
    from recurrent_fusion_network_tpu import config as j_config

    cli = RECIPES[name]
    root = _recorded(tmp_path, os.path.join(REPO, "scripts", name), tmp_path / "root", env)
    port = _recorded(tmp_path, os.path.join(SCRIPTS, name), tmp_path / "port", env)
    assert root[0] == f"{cli}.py" and port[:2] == ["-m", PORT + cli], (root, port)
    _, parsed = _parse(port)
    port_pre, port_opt = parsed if isinstance(parsed, tuple) else (None, parsed)
    want = _options(ROOT_PRE[cli], j_config.parse_opt, root[1:])
    got = _options(ROOT_PRE[cli], t_config.parse_opt, port[2:])
    assert {k: _comparable(got[k]) for k in want} == {k: _comparable(v) for k, v in
                                                       want.items()}
    assert vars(port_opt) == {k: v for k, v in got.items() if k in vars(port_opt)}
    if port_pre is not None:
        assert vars(port_pre) == {k: got[k] for k in vars(port_pre)}
    if env:  # the variables reached the command
        key, value = {"eval": ("load_model_id", "r7"),
                      "eval_ensemble": ("model_ids", "a,b:1")}.get(cli, ("id", "r7"))
        assert got[key] == value
        if cli.startswith("eval"):
            assert got["beam_size"] == 2
        else:  # SEED reaches the ReviewNet recipes; the fleet's seeds start at 1
            assert got["seed"] == (3 if name.startswith("train_review") else 1)
