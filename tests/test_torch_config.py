"""The torch port's configs equal the reference's, and the port stands alone:
it imports without jax, imports nothing of `repro`, and its entry points
refuse to run on the CPU unless asked."""
import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro import configs as jcfg
from repro_torch import configs as tcfg

PORT = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
ARCHS = ("paper-lm", "llama3.2-1b")


def _variants(cfgs):
    base = cfgs.get_config
    return {
        "plain": lambda a: base(a),
        "reduced": lambda a: base(a).reduced(),
        "with_head": lambda a: base(a).with_head(quantizer="pq", midx_k=16,
                                                 decode_candidates=8),
        "with_serve": lambda a: base(a).with_serve(max_slots=3, page_size=8,
                                                   max_seq=40),
    }


@pytest.mark.parametrize("variant", ["plain", "reduced", "with_head",
                                     "with_serve"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, variant):
    ref = _variants(jcfg)[variant](arch)
    port = _variants(tcfg)[variant](arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.padded_vocab == ref.padded_vocab
    assert port.resolved_head_dim == ref.resolved_head_dim
    assert port.serve.resolved_num_pages == ref.serve.resolved_num_pages


def test_every_reference_arch_is_carried():
    assert sorted(tcfg.ARCHS) == sorted(jcfg.ARCHS)
    for name in jcfg.ARCHS:
        assert dataclasses.asdict(tcfg.get_config(name)) == \
            dataclasses.asdict(jcfg.get_config(name))


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield path, ".".join(parts)


def test_no_jax_or_reference_import_in_port_sources():
    bad = []
    for path, _ in _port_modules():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "repro", "flax", "optax"):
                    bad.append(f"{path.name}: import {n}")
    assert not bad, bad


def test_port_imports_with_jax_blocked():
    mods = [m for _, m in _port_modules()]
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in [k for k, v in sys.modules.items() if v]\n"
            "print('ok', len(" f"{mods!r}" "))\n")
    src = str(PORT.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": src})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_refuse_the_cpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is legitimate")
    from repro_torch.models import init_params
    from repro_torch.serve import Engine
    cfg = tcfg.get_config("paper-lm").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    from repro_torch.launch import serve as serve_cli
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve_cli.main(["--reduced", "--requests", "1"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve_cli.main(["--reduced", "--swap-step", "2"])


def test_unported_engine_features_raise():
    from repro_torch.serve import Engine
    cfg = tcfg.get_config("paper-lm").reduced()
    eng = Engine(cfg, device="cpu")
    # the index hot-swap is ported: each entry point runs
    rebuilt = eng.rebuild_index()
    assert torch.equal(rebuilt.sorted_ids, eng.index.sorted_ids)
    assert eng.swap_index(rebuilt) is True and eng.index is rebuilt
    eng.schedule_swap(eng.index, at_step=2)
    assert eng._pending_swap == (2, eng.index)
    assert eng.stats.counters()["swaps"] == 1
    for arch in ("granite-moe-1b-a400m", "zamba2-7b"):   # moe, hybrid
        other = Engine(tcfg.get_config(arch).reduced(), device="cpu")
        assert other.index.sorted_ids.numel() == other.cfg.padded_vocab
    # the generic contenders serve: a uniform head builds its state
    uni = Engine(cfg, head="uniform", device="cpu")
    assert uni.proposal.name == "uniform"
    assert uni.index == {"n": cfg.padded_vocab}
    with pytest.raises(ValueError, match="greedy"):
        Engine(cfg.with_head(decode_temperature=0.0), head="midx",
               device="cpu")
