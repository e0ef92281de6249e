"""The port stands alone: no module of tendermint_tpu_torch, and not
chip_smoke.py, imports jax or anything of tendermint_tpu, no C or CUDA
source of the port includes anything of the JAX package or native/, and
the entry points never pick the CPU by themselves."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "tendermint_tpu_torch"


def _forbidden(name: str) -> bool:
    # "tendermint_tpu_torch".startswith("tendermint_tpu") is true, so the
    # JAX package is matched by equality or by its "tendermint_tpu." prefix
    return (
        name in ("jax", "tendermint_tpu")
        or name.startswith(("jax.", "jaxlib", "tendermint_tpu."))
    )


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_no_source_imports_jax_or_the_jax_package():
    bad = []
    for path in _sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}: {n}" for n in names if _forbidden(n)]
    assert bad == []


def test_no_c_source_includes_the_jax_package_or_native():
    srcs = sorted((PORT / "csrc").iterdir())
    assert {"host_prep.cpp", "merlin.cpp"} <= {p.name for p in srcs}
    bad = [
        f"{p.name}: {line.strip()}"
        for p in srcs
        for line in p.read_text().splitlines()
        if line.lstrip().startswith("#include")
        and any(k in line for k in ("native", "tendermint_tpu", "Python.h", "tm_native"))
    ]
    assert bad == []


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import tendermint_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for m in mods + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "from tendermint_tpu_torch.ops import host\n"
        "host.library()\n"
        "maps = [l.split()[-1] for l in open('/proc/self/maps') if l.rstrip().endswith('.so')]\n"
        "print(json.dumps([mods, sorted(sys.modules), sorted(set(maps))]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    mods, loaded, libs = json.loads(out.stdout.strip().splitlines()[-1])
    assert {
        "tendermint_tpu_torch.types.validation",
        "tendermint_tpu_torch.ops.rlc",
        "tendermint_tpu_torch.ops.epoch_cache",
        "tendermint_tpu_torch.ops.verify",
        "tendermint_tpu_torch.ops.sr25519",
        "tendermint_tpu_torch.ops.mixed",
        "tendermint_tpu_torch.ops.host",
        "tendermint_tpu_torch.ops.commit_prep",
        "tendermint_tpu_torch.ops.entry_block",
        "tendermint_tpu_torch.crypto.merkle",
        "tendermint_tpu_torch.crypto.tmhash",
        "tendermint_tpu_torch.crypto.sr25519",
        "tendermint_tpu_torch.crypto._ristretto",
        "tendermint_tpu_torch.crypto._merlin",
    } <= set(mods)
    assert [m for m in loaded if _forbidden(m)] == []
    # the host library is the port's own build, never the JAX package's
    # native extension
    assert any("/build/host/libtm_host-" in p for p in libs)
    assert not any("tm_native" in p or "/native/" in p for p in libs)


def test_entry_points_default_to_cuda():
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.crypto import ed25519
    from tendermint_tpu_torch.device import resolve_device
    from tendermint_tpu_torch.types import validation
    from tendermint_tpu_torch.types.block import BlockID, Commit

    from tendermint_tpu_torch.crypto import sr25519

    pk = ed25519.gen_priv_key(bytes(range(32))).pub_key()
    sr_pk = sr25519.PubKey(bytes(32))
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        assert batch.create_batch_verifier(pk).device.type == "cuda"
        assert batch.create_batch_verifier(sr_pk).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    for key in (pk, sr_pk):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            batch.create_batch_verifier(key)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        validation.verify_commit("c", None, BlockID(), 1, Commit())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        validation.verify_commit_light("c", None, BlockID(), 1, Commit())
    # the CPU only when asked for
    assert batch.create_batch_verifier(pk, device="cpu").device.type == "cpu"
    assert batch.create_batch_verifier(sr_pk, device="cpu").device.type == "cpu"


def test_unsupported_devices_raise():
    from tendermint_tpu_torch.device import resolve_device

    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
