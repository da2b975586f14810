"""The PyTorch port stands alone: nothing under ``src/repro_torch`` nor
``chip_smoke.py`` imports JAX or the JAX package, and its entry points run
on the card unless the caller asks for the CPU."""
import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

# one intra-op thread per process: the suite runs several pytest workers
# on a few cores, and torch's default pool (a thread per core) in each of
# them oversubscribes the CPU many times over
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
                and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"engine.py", "ternary.py", "ops.py", "paged.py", "chip_smoke.py", "qlora.py",
            "registry.py", "cache.py", "runtime.py", "from_checkpoint.py", "flash_decode.py",
            "ref.py", "kv.py"} <= names


def test_entry_points_need_the_card_or_cpu():
    """Without a card, the default device raises; ``device="cpu"`` runs."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.convert import params_from_jax
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve
    from repro_torch.models.transformer import Model

    cfg = reduce_config(get_config("bitnet-2b"), "tiny")
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({"layers": {}}, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--preset", "tiny", "--requests", "1"])
    assert resolve_device("cpu").type == "cpu"
    assert Model(cfg, device="cpu").device.type == "cpu"


def test_chip_smoke_refuses_without_card_or_checkout(tmp_path):
    """Run alone in an empty directory (and here without a card) the smoke
    script exits non-zero and prints no result."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    for script in (ROOT / "chip_smoke.py", lone):
        if script == ROOT / "chip_smoke.py" and torch.cuda.is_available():
            continue
        proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
