"""One rank of a ``torch.distributed`` gloo world, for the tensor parallel
tests (``tests/test_torch_tp.py`` on the CPU, ``tests/test_torch_kernels_cuda.py``
with every rank on ``cuda:0``). It imports neither JAX nor the JAX package.

    python tests/torch_tp_worker.py PORT RANK WORLD JOB OUT

``JOB`` is a ``torch.save``-d dict {"cases": [case, ...]}; each case names
its ``kind`` ("layer", "row", "generate", "engine", "multihost"), the port's
config and params and its inputs (a "layer" case also its ``device``).
Every rank runs every case in order and writes {case name: result} to
``OUT/rank<RANK>.pt``. The process group is made with a 60 s timeout, so a
hung collective ends the rank with an error. :func:`run_world` starts a
world of these and gathers what its ranks wrote.
"""

import os
import socket
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pt2tpu_torch.models import decoder as dec  # noqa: E402
from pt2tpu_torch.parallel import mesh, tp  # noqa: E402
from pt2tpu_torch.serve.engine import ServeEngine  # noqa: E402


def _engine_outs(eng, case, rank):
    reqs = [eng.submit(p, max_new=n) for p, n in case["requests"]] if rank == 0 else []
    eng.run()
    if rank == 0:
        return [list(r.out) for r in reqs]
    return [list(r.out) for r in sorted(eng.finished, key=lambda r: r.uid)]


def run_case(case, rank, world):
    cfg, kind = case["cfg"], case["kind"]
    torch.manual_seed(0)
    if kind == "multihost":  # the default engine on every rank, rank 0 planning
        eng = ServeEngine(cfg, case["params"], max_batch=case["max_batch"],
                          max_len=case["max_len"], multihost=True)
        assert eng._mh and eng._proc0 == (rank == 0)
        return _engine_outs(eng, case, rank)
    ways = case["ways"]
    axis = mesh.make_mesh({"data": world // ways, "model": ways})["model"]
    if kind == "row":
        p = tp._shard_linear(case["linear"], "row", axis.rank, axis.size, "cpu")
        return [tp.tp_row_apply(p, case["x"], axis, chunks=c) for c in case["chunks"]]
    if kind == "layer":
        dev = torch.device(case.get("device", "cpu"))
        lp = tp.shard_tp_layer(tp.prepare_tp_layer(cfg, case["layer"], ways), axis, dev)
        x = case["x"].to(dev)
        L = x.shape[1]
        cos, sin, cos_l, sin_l = dec.pos_tables(cfg, L, device=dev)
        mask = dec.build_mask(cfg, L, L, device=dev)
        out = tp.tp_layer_forward(cfg, lp, x, cos, sin, mask, axis=axis, chunks=2,
                                  cos_loc=cos_l, sin_loc=sin_l)
        return out.cpu()
    shard = tp.shard_tp_params(tp.prepare_tp_params(cfg, case["params"], ways), axis)
    if kind == "generate":
        return tp.tp_generate(cfg, axis, shard, case["prompt"], case["max_new"],
                              max_len=case["max_len"])
    if kind == "engine":
        pf, df = tp.make_tp_engine_fns(cfg, axis, shard)
        eng = ServeEngine(cfg, shard, max_batch=case["max_batch"], max_len=case["max_len"],
                          kv_heads=cfg.kv_heads // ways, prefill_fn=pf, decode_fn=df,
                          multihost=True)
        return _engine_outs(eng, case, rank)
    raise ValueError(f"unknown case kind {kind!r}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(cases, world: int, tmp: str, timeout_s: float = 120.0) -> list:
    """Run ``cases`` on every rank of a gloo world of ``world`` processes
    (``OMP_NUM_THREADS=1``); returns each rank's {case name: result}. A rank
    that fails, or a world that outlives ``timeout_s``, raises (every rank
    is killed first)."""
    os.makedirs(tmp, exist_ok=True)
    job = os.path.join(tmp, "job.pt")
    torch.save({"cases": cases}, job)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=root)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(port), str(r),
                               str(world), job, tmp], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env, cwd=root)
             for r in range(world)]
    errs = []
    try:
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                errs.append(f"rank {r}: no answer within {timeout_s} s")
                break
            if p.returncode != 0:
                errs.append(f"rank {r} exit {p.returncode}: {err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if errs:
        raise RuntimeError("\n".join(errs))
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def main():
    port, rank, world, job, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    mesh.initialize_distributed(backend="gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world, timeout_s=60)
    cases = torch.load(job, weights_only=False)["cases"]
    results = {}
    with torch.inference_mode():
        for case in cases:
            results[case["name"]] = run_case(case, rank, world)
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()
    print("OK", rank)


if __name__ == "__main__":
    main()
