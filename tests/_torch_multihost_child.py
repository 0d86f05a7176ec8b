"""One process of a multi-process run of the port's sharded NTT
(tests/test_torch_multihost.py on the CPU, chip_smoke.py on the card).

Usage: python _torch_multihost_child.py <rank> <world> <init_method> <k>
           <out> <flat|hybrid> <device> <shards> [<backend>]

Joins the process group (`init_multihost`; gloo unless <backend> is
named), builds a global (flat) or hybrid (processes x shards) mesh of
<shards> shards of <device> in this process, and runs ShardedNTT forward
and inverse over BN254's 2^k subgroup on the coefficients
random.Random(77) draws.  The round trip must give the coefficients back;
rank 0 writes the forward output's Montgomery words to <out>
(`torch.save`).  Imports nothing of JAX or of the JAX package.
"""

import os
import random
import sys

sys.modules["jax"] = None
sys.modules["halo2_tpu"] = None
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402


def main():
    rank, world, init, k, out, layout, device, shards = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4]),
        sys.argv[5], sys.argv[6], sys.argv[7], int(sys.argv[8]))
    backend = sys.argv[9] if len(sys.argv) > 9 else "gloo"
    torch.set_num_threads(1)
    import torch.distributed as dist
    from halo2_tpu_torch.dist import ShardedNTT
    from halo2_tpu_torch.dist.multihost import (allgather_rows, global_mesh,
                                                hybrid_mesh, init_multihost,
                                                put_row_sharded)
    from halo2_tpu_torch.fields import BN254_FR as F

    init_multihost(init, world, rank, backend)
    make = hybrid_mesh if layout == "hybrid" else global_mesh
    mesh = make([torch.device(device)] * shards)
    assert mesh.size == world * shards and mesh.procs == world
    ntt = ShardedNTT(mesh, F, k)
    rng = random.Random(77)
    a = F.encode_ints([rng.randrange(F.p) for _ in range(1 << k)], device)
    out_slabs = ntt.forward(put_row_sharded(mesh, a))
    back = allgather_rows(mesh, ntt.inverse(out_slabs))
    full = allgather_rows(mesh, out_slabs, "cpu")
    assert torch.equal(back, a), "multi-process NTT round trip failed"
    if rank == 0:
        torch.save(full, out)
    # every process stays until the others are done with the collectives
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
