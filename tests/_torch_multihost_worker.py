"""Worker for test_torch_multihost.py's multi-process runs.

One of N processes joined by torch.distributed over TCP (gloo, CPU
entries): builds the process-major hybrid mesh, places only ITS rows of
the gallery, and answers a sharded top-k, a slot-sharded IVF probe at
nprobe == C and a dedup ring pass, then decodes a tiny LLaMA with the
decoder tensor-parallel over each process's model axis and the batch
rows over the data axis across processes (parallel/vlm.make_tp_generate:
the model axis never crosses a process); writes the answers as JSON for
the parent test to hold against each other, a numpy oracle and the
single-process decode.

argv: coord nproc pid out_path [local_devices=2] [model_size=1] [weights]
(coord: host:port or a rendezvous URL such as file:///path; weights: the
npz of the LLaMA to decode with, none for no decode)
"""

import json
import sys


def main() -> None:
    coord, nproc, pid, out_path = sys.argv[1:5]
    local_devices = int(sys.argv[5]) if len(sys.argv) > 5 else 2
    model_size = int(sys.argv[6]) if len(sys.argv) > 6 else 1
    weights = sys.argv[7] if len(sys.argv) > 7 else None

    import numpy as np
    import torch

    torch.set_num_threads(1)

    from mmrs_tpu_torch.config import MeshConfig
    from mmrs_tpu_torch.index.ivf import build_ivf
    from mmrs_tpu_torch.parallel.dedup import sharded_first_match
    from mmrs_tpu_torch.parallel.ivf import place_ivf, sharded_ivf_topk
    from mmrs_tpu_torch.parallel.multihost import (distributed_init,
                                                   make_hybrid_mesh,
                                                   place_global_rows,
                                                   process_count,
                                                   process_local_rows)
    from mmrs_tpu_torch.parallel.topk import sharded_cosine_topk

    assert distributed_init(coord, int(nproc), int(pid)) is True
    assert process_count() == int(nproc)
    cpu = torch.device("cpu")
    mesh = make_hybrid_mesh(MeshConfig(model_size=model_size),
                            [cpu] * local_devices)

    n, dim = 1000, 32
    lo, hi = process_local_rows(n, mesh)
    # every process makes the same values but PLACES only its own rows
    rng = np.random.default_rng(0)
    g = rng.normal(size=(n, dim)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    q = torch.from_numpy(g[[3, 500, 997]])

    blocks = place_global_rows(g[lo:hi], n, mesh)
    vals, idxs = sharded_cosine_topk(q, blocks, k=5, mesh=mesh, n_valid=n)

    ivf = place_ivf(build_ivf(g, n_clusters=8, iters=3, seed=1,
                              dtype=torch.float32, device=cpu), mesh)
    _, ivf_idxs = sharded_ivf_topk(q, ivf, k=5, nprobe=8, mesh=mesh)

    rng_d = np.random.default_rng(7)
    xd = rng_d.normal(size=(96, 16)).astype(np.float32)
    xd[41] = xd[3] + 1e-4 * rng_d.normal(size=16).astype(np.float32)
    xd[77] = xd[3] + 1e-4 * rng_d.normal(size=16).astype(np.float32)
    xd[90] = xd[58]
    xd /= np.linalg.norm(xd, axis=1, keepdims=True)
    dedup_first = sharded_first_match(torch.from_numpy(xd), tau=0.999,
                                      mesh=mesh, intra=True)

    decode = None
    if weights:
        # the pod VLM serving shape of tests/_multihost_worker.py: the
        # parent's weights and prompt seed, B=4 over the data axis
        from mmrs_tpu_torch.models import checkpoint, convert_jax, llama
        from mmrs_tpu_torch.parallel.vlm import (make_tp_generate,
                                                 shard_llama_params)

        lcfg = llama.LlamaConfig(vocab_size=96, dim=64, layers=2, heads=4,
                                 kv_heads=2, mlp_dim=128, max_seq=64)
        model = convert_jax.from_jax_llama(checkpoint.load_npz(weights),
                                           lcfg)
        prompt = torch.from_numpy(
            np.random.default_rng(4).integers(3, 90, (4, 5)))
        gen = make_tp_generate(lcfg, mesh, max_new_tokens=6, eos_token=-1,
                               compute_dtype=torch.float32)
        decode = gen(shard_llama_params(model, mesh),
                     llama.embed_tokens(model, prompt)).tolist()

    with open(out_path, "w") as f:
        json.dump({
            "pid": int(pid),
            "mesh_shape": mesh.shape,
            "proc_grid": mesh.owner.tolist(),
            "local_rows": [lo, hi],
            "placed": [b is not None for b in blocks],
            "vals": vals.tolist(),
            "idxs": idxs.tolist(),
            "ivf_idxs": ivf_idxs.tolist(),
            "dedup_first": dedup_first.tolist(),
            "decode": decode,
        }, f)


if __name__ == "__main__":
    main()
