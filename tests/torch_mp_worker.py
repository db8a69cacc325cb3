"""Worker process for tests/test_torch_distributed.py.

Joins a gloo process group over CPU devices, loads the index the parent
test saved, serves the global query list on a mesh of 4 CPU slots with
``ShardedFmEngine`` and checks its own slice against the counts the parent
computed.  Imports neither JAX nor the JAX package.

Usage: python tests/torch_mp_worker.py <process_id> <num_processes> <port> <shard_size> <data_dir>
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main():
    pid, nproc, port, shard_size = (int(x) for x in sys.argv[1:5])
    data_dir = sys.argv[5]
    from awry_tpu_torch import load_artifact
    from awry_tpu_torch.parallel import ShardedFmEngine
    from awry_tpu_torch.parallel.distributed import (
        init_distributed,
        make_global_mesh,
        process_count,
        process_index,
        process_local_queries,
    )

    init_distributed(f"localhost:{port}", nproc, pid, backend="gloo")
    init_distributed(f"localhost:{port}", nproc, pid, backend="gloo")  # a second call is ignored
    assert process_count() == nproc and process_index() == pid

    index = load_artifact(os.path.join(data_dir, "index.npz"))
    with open(os.path.join(data_dir, "queries.txt"), "rb") as f:
        queries = f.read().split(b"\n")
    expected = np.load(os.path.join(data_dir, "counts.npy"))

    mesh = make_global_mesh(shard_size=shard_size, devices=["cpu"] * 4)
    assert mesh.shape == {"data": 4 // shard_size, "shard": shard_size}
    engine = ShardedFmEngine(index, mesh)
    local = process_local_queries(queries, mesh)
    per = -(-len(queries) // nproc)
    want = expected[pid * per : (pid + 1) * per]
    assert local == queries[pid * per : (pid + 1) * per]
    counts = engine.count_batch(queries)
    np.testing.assert_array_equal(counts.astype(np.int64), want)
    arrays = engine.count_locate_arrays(queries)
    np.testing.assert_array_equal(arrays[0].astype(np.int64), want)
    assert arrays[3][-1] == want.sum()

    import torch.distributed as dist

    total = torch.tensor([len(local)], dtype=torch.int64)
    dist.all_reduce(total)
    assert int(total) == len(queries), int(total)
    assert "jax" not in sys.modules and "awry_tpu" not in sys.modules
    dist.destroy_process_group()
    print(f"proc {pid} shard_size={shard_size}: {len(local)} local queries OK", flush=True)


if __name__ == "__main__":
    main()
