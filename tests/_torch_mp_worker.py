"""Worker of tests/test_torch_multiprocess.py: one rank of a gloo process
group on the CPU, through the port's init_distributed. Imports nothing of
JAX: expected results arrive in a file.

  python _torch_mp_worker.py <port> <rank> <n> <genome.npy> <want.npz>
      compare_sharded over the default mesh of the n ranks (a ProcessMesh);
      every rank must hold the full table, equal to want.npz.

Prints one line "MESH_OK <rank> <is_output_host> <sha256 of the table>".
"""

import hashlib
import sys

import numpy as np
import torch

from repkiller_tpu_torch.config import Config
from repkiller_tpu_torch.dist.mesh import ProcessMesh, init_distributed, make_mesh
from repkiller_tpu_torch.dist.merge import is_output_host
from repkiller_tpu_torch.dist.sharded import compare_sharded

CFG = Config(k=12, strands="fr", hit_capacity=1 << 12, max_extend=128)


def _digest(table) -> str:
    h = hashlib.sha256()
    for k in sorted(table):
        h.update(np.ascontiguousarray(table[k]).tobytes())
    return h.hexdigest()


def main() -> None:
    port, rank, n = map(int, sys.argv[1:4])
    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", n, rank, device="cpu")
    codes = np.load(sys.argv[4])
    mesh = make_mesh(device="cpu")
    assert isinstance(mesh, ProcessMesh) and mesh.bodies == [divmod(rank, 2)]
    got = compare_sharded(codes, None, CFG, mesh)
    with np.load(sys.argv[5]) as z:
        want = {k: z[k] for k in z.files}
    assert got.keys() == want.keys(), (sorted(got), sorted(want))
    for k in want:
        assert np.array_equal(got[k], want[k]), (k, got[k][:8], want[k][:8])
    print(f"MESH_OK {rank} {int(is_output_host())} {_digest(got)}", flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
