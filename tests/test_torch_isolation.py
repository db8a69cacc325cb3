"""Import isolation of the port, and its profiling helpers.

In fresh interpreters: every module of awry_tpu_torch and chip_smoke import
without loading jax or any module of awry_tpu; the NumPy host engine's
count and locate, and --host on a .npz file, answer without loading torch.  In process:
a CPU trace from device_trace."""

import json
import os
import subprocess
import sys

import pytest
import torch

from awry_tpu_torch.utils.profiling import device_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(code: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=300)


def test_port_and_chip_smoke_import_no_jax():
    r = _python(
        "import importlib, json, pkgutil, sys\n"
        "import awry_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(awry_tpu_torch.__path__, 'awry_tpu_torch.')]\n"
        "for name in names: importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'awry_tpu'))\n"
        "print(json.dumps({'modules': names, 'bad': bad}))\n"
    )
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout)
    assert out["bad"] == []
    for name in ("awry_tpu_torch.host_engine", "awry_tpu_torch.native.cpu_ref", "awry_tpu_torch.utils.profiling",
                 "awry_tpu_torch.ops.kernels", "awry_tpu_torch.parallel.sharding", "awry_tpu_torch.__main__"):
        assert name in out["modules"]


def test_package_count_loads_no_torch():
    """The package and its NumPy host engine answer without loading torch;
    the package's own count (the card engine, awry_tpu's name) loads it on
    first use."""
    r = _python(
        "import json, sys\n"
        "import awry_tpu_torch as pt\n"
        "from awry_tpu_torch.host_engine import count, count_batch, locate, locate_batch\n"
        "idx = pt.build_from_records([('a', b'ACGTACGTTTGACGT' * 20), ('b', b'GGACGTA')],\n"
        "                            pt.FmBuildArgs(lookup_table_kmer_len=3))\n"
        "out = {'count': count(idx, b'ACGT'), 'batch': count_batch(idx, ['ACGT', 'TTGA']).tolist(),\n"
        "       'locate': sorted(locate(idx, b'GGACG')), 'n': len(locate_batch(idx, [b'ACGT'])[0]),\n"
        "       'torch': 'torch' in sys.modules}\n"
        "from awry_tpu_torch import count as card_count\n"
        "out['card'] = [card_count.__module__, 'torch' in sys.modules, card_count(idx, b'ACGT', device='cpu')]\n"
        "print(json.dumps(out))\n"
    )
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout)
    assert out == {"count": 61, "batch": [61, 20], "locate": [[1, 0]], "n": 61, "torch": False,
                   "card": ["awry_tpu_torch.fm_index", True, 61]}


def test_host_cli_on_npz_loads_no_torch(tmp_path):
    """--host on a .npz index answers through the host engine and loads no
    torch (only a .awry file's loader needs it)."""
    r = _python(
        "import contextlib, io, json, sys\n"
        "import awry_tpu_torch as pt\n"
        "from awry_tpu_torch.__main__ import main\n"
        "idx = pt.build_from_records([('a', b'ACGTACGTTTGACGT' * 20), ('b', b'GGACGTA')],\n"
        "                            pt.FmBuildArgs(lookup_table_kmer_len=3))\n"
        f"path = {str(tmp_path / 'i.npz')!r}\n"
        "pt.save_artifact(idx, path)\n"
        "buf = io.StringIO()\n"
        "with contextlib.redirect_stdout(buf):\n"
        "    rcs = [main(['count', path, 'ACGT', 'TTGA', '--host']), main(['locate', path, 'GGACG', '--host'])]\n"
        "print(json.dumps({'rcs': rcs, 'lines': buf.getvalue().splitlines(), 'torch': 'torch' in sys.modules}))\n"
    )
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout)
    assert out == {"rcs": [0, 0], "lines": ["ACGT\t61", "TTGA\t20", "GGACG\tb\t0"], "torch": False}


def test_device_trace_cpu(tmp_path):
    a = torch.ones(64, 64)
    with device_trace(str(tmp_path / "trace"), device="cpu") as prof:
        torch.mm(a, a)
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "trace" / files[0]) as f:
        trace = json.load(f)
    assert any(e.get("name") == "aten::mm" for e in trace["traceEvents"])
    assert any(e.key == "aten::mm" for e in prof.key_averages())


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal on a machine without a card")
def test_device_trace_needs_a_card(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with device_trace(str(tmp_path / "t")):
            pass
    assert not (tmp_path / "t").exists()
