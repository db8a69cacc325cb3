"""The port's split over processes on the CPU: two spawned processes join a
gloo process group, each serves its slice of a global query list with
awry_tpu_torch's ShardedFmEngine on a mesh of 4 CPU slots (Mode A and Mode
B), and checks it against the JAX package's host engine.  The twin of
tests/test_distributed.py; the workers import neither JAX nor the JAX
package, so the parent writes the index (save_artifact) and the expected
counts (awry_tpu.host_engine.count_batch) before they start."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import awry_tpu.host_engine as he
from awry_tpu import Alphabet, FmBuildArgs, build_from_records, save_artifact

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_mp_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_workers(nproc: int, shard_size: int, data_dir: str, timeout: int = 240):
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(pid), str(nproc), str(port), str(shard_size), data_dir],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        )
        for pid in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
        assert f"proc {pid} shard_size={shard_size}" in out, out[-2000:]


@pytest.mark.parametrize("shard_size", [1, 2])
def test_two_process_sharded_engine(shard_size, tmp_path):
    """2 processes x 4 CPU slots: replicated (Mode A) and range-sharded
    (Mode B) engines give host-engine-exact counts on each process's
    slice."""
    rng = np.random.default_rng(7)
    seq = bytes(rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=3000))
    index = build_from_records([("mp", seq)], FmBuildArgs(alphabet=Alphabet.NUCLEOTIDE, lookup_table_kmer_len=4))
    queries = [seq[i : i + 12] for i in range(0, 480, 3)] + [b"ACGTACGTACGT", b"TTTTTTTTTTTT", b"ACGTN"]
    save_artifact(index, str(tmp_path / "index.npz"))
    np.save(tmp_path / "counts.npy", he.count_batch(index, queries).astype(np.int64))
    (tmp_path / "queries.txt").write_bytes(b"\n".join(queries))
    _run_workers(2, shard_size, str(tmp_path))
