"""Dry run of the port's production steps on the meta device (port of
``repro/launch/dryrun.py``).

The reference lowers and compiles every (architecture x input shape) on a
256- or 512-chip TPU mesh and reads memory, FLOPs, bytes and collectives
from the compiled program. The port has no compiler: it builds the step
it would run on the card (``launch.steps``) on the ``meta`` device, which
allocates nothing, and runs it once under ``launch.op_cost.OpCounter``,
which sees the same op sequence the card runs. From that run it records
FLOPs, bytes moved, the peak of live bytes (the caching allocator's
512-byte blocks, ``torch.utils.checkpoint``'s recomputation included),
the roofline terms on the H100's constants (``launch.roofline``) and the
useful-FLOP ratio; and from the ported sharding rules, each device's
share of the arguments on the mesh.

What the numbers describe: the one-device step the port runs, at the
per-device batch (the global batch over the mesh's batch extent, pod x
data, where it divides; replicated where it does not). Params are whole
and no tensor parallelism is applied; on a mesh with a ``pod`` axis the
train step is the port's multi-pod step with one client a pod (each
client's replica of the params on the one device). ``argument_bytes`` is
one device's share of the params and inputs under the sharding rules;
``peak_bytes_per_device`` is the one-device step's peak, which ``fits``
holds against the card's 80 GB. Trip-count correction has no counterpart:
the port's Python loops dispatch each op as often as it runs.

Usage (no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi3-mini-3.8b \\
      --shape train_4k [--multi-pod] [--out experiments/dryrun]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --cohort [--cohort-r 32]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Optional, Union

import torch

from repro_torch import prng
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.base import ModelConfig, PFELSConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import inputs as I
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import MeshShape, cohort_shape, \
    make_production_mesh
from repro_torch.launch.op_cost import ALLOC_ROUND, OpCounter
from repro_torch.launch.roofline import HBM_BYTES, model_flops, \
    roofline_terms
from repro_torch.models import transformer as T
from repro_torch.sharding.rules import PURE_FSDP, logical_overrides, \
    shard_shape, tree_specs
from repro_torch.tree import tree_leaves

NOTE = ("costs and peak of the one-device step the port runs on the "
        "meta device: params whole, no tensor parallelism, the per-device "
        "batch; argument_bytes is one device's share under the sharding "
        "rules")

# the reference's tuned variants (``--perf``); the baseline tables use the
# plain configs
PERF_VARIANTS = {
    # dense-family train shapes: activation collectives >> weight
    # collectives at <= ~4B params -> pure FSDP + larger flash block
    ("phi3-mini-3.8b", "train_4k"): dict(parallelism="fsdp",
                                         attn_block_kv=1024),
    ("mamba2-130m", "train_4k"): dict(parallelism="fsdp"),
    # memory-bound 32k prefill: quarter the flash accumulator round-trips
    ("qwen2.5-14b", "prefill_32k"): dict(attn_block_kv=2048),
}


def grad_accum(cfg: ModelConfig, multi_pod: bool) -> int:
    """The reference's microbatch count of the production train step
    (activation memory of the widest models)."""
    accum = 4 if cfg.d_model >= 8192 else (
        2 if (cfg.d_model >= 5120 or cfg.moe is not None) else 1)
    if cfg.family == "hybrid":
        accum = max(accum, 2)   # SSD chunk intermediates (80 heads)
    if multi_pod:
        if cfg.moe is not None:
            # per-pod MoE dispatch buffers under the client vmap
            accum = 8 if cfg.moe.num_experts >= 64 else 4
        elif cfg.d_model >= 8192:
            accum = 8
    return accum


def default_pfels(cfg: ModelConfig, mesh: MeshShape) -> PFELSConfig:
    """The reference's ``PFELSConfig`` of the dry run: a fleet of 1000
    edge sites, one a pod this round, local_steps 1."""
    multi_pod = mesh.shape.get("pod", 1) > 1
    return PFELSConfig(compression_ratio=0.3, epsilon=1.5, num_clients=1000,
                       local_steps=1,
                       clients_per_round=mesh.shape.get("pod", 1),
                       grad_accum=grad_accum(cfg, multi_pod))


def _rows_per_device(global_batch: int, mesh: MeshShape) -> int:
    div = I.batch_div(mesh)
    return global_batch // div if global_batch % div == 0 else global_batch


def _spec_bytes(tree, specs, mesh) -> int:
    """One device's bytes of a tree of tensors under the matching tree of
    specs."""
    if isinstance(tree, torch.Tensor):
        n = math.prod(shard_shape(tuple(tree.shape), specs, mesh))
        return n * tree.element_size()
    if isinstance(tree, dict):
        return sum(_spec_bytes(v, specs[k], mesh) for k, v in tree.items())
    return sum(_spec_bytes(v, sp, mesh) for v, sp in zip(tree, specs))


def _storages(tensors) -> dict:
    return {t.untyped_storage()._cdata: t for t in tensors}


def _build(cfg: ModelConfig, shape: InputShape, mesh: MeshShape,
           pfels: PFELSConfig):
    """(the step, its arguments on meta at the per-device batch, one
    device's argument bytes under the sharding rules, tokens the step
    processes, the step's client count)."""
    params = T.init_shapes(cfg)
    logical = T.logical_axes(cfg)
    n_pods = mesh.shape.get("pod", 1)
    rows = _rows_per_device(shape.global_batch, mesh)
    local = dataclasses.replace(shape, global_batch=rows)
    if shape.kind == "train":
        d = T.param_count(params)
        if n_pods > 1:
            # one client a pod, each with its own replica and its rows
            params = S.clientize_shapes(params, n_pods)
            logical = S.clientize_logical(logical, n_pods)
            local = dataclasses.replace(shape, global_batch=rows * n_pods)
        batch, specs = I.train_batch_specs(cfg, shape, mesh)
        args_bytes = _spec_bytes(batch, specs, mesh)
        step = S.make_pfels_train_step(cfg, pfels, d, n_clients=n_pods)
        args = (params, I.train_batch_specs(cfg, local),
                prng.PRNGKey(0, "meta"))
        tokens = local.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        batch, specs = I.prefill_batch_specs(cfg, shape, mesh)
        args_bytes = _spec_bytes(batch, specs, mesh)
        step = S.make_prefill_step(cfg)
        args = (params, I.prefill_batch_specs(cfg, local))
        tokens = local.global_batch * shape.seq_len
    else:
        window = I.long_context_window(cfg, shape)
        spec_in, specs = I.decode_specs(cfg, shape, mesh, window=window)
        args_bytes = _spec_bytes(spec_in, specs, mesh)
        del spec_in
        run_in = I.decode_specs(cfg, local, window=window)
        step = S.make_serve_step(cfg, window=window)
        args = (params, run_in["token"], run_in["caches"],
                run_in.get("enc_out"))
        tokens = local.global_batch
    args_bytes += _spec_bytes(params, tree_specs(mesh, logical, params),
                              mesh)
    return step, args, args_bytes, tokens, (n_pods if shape.kind == "train"
                                            else 1)


def dryrun_one(arch: str, shape: Union[str, InputShape], *,
               mesh: Optional[MeshShape] = None, multi_pod: bool = False,
               cfg: Optional[ModelConfig] = None,
               pfels: Optional[PFELSConfig] = None, perf: bool = False,
               verbose: bool = True) -> dict:
    """Build ``arch``'s step for ``shape`` (a name of ``SHAPES`` or an
    ``InputShape``) on the meta device, run it once under the counter and
    return the record (see the module's docstring). ``mesh`` defaults to
    the production mesh (``multi_pod``: two pods); ``cfg`` replaces
    ``get_config(arch)`` (a cut depth); ``pfels`` the reference's default
    ``PFELSConfig`` for the mesh."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    if perf and (arch, shape.name) in PERF_VARIANTS:
        cfg = dataclasses.replace(cfg, **PERF_VARIANTS[(arch, shape.name)])
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    pfels = pfels or default_pfels(cfg, mesh)
    par_ctx = (logical_overrides(PURE_FSDP) if cfg.parallelism == "fsdp"
               else contextlib.nullcontext())
    t0 = time.perf_counter()
    with par_ctx:
        step, args, args_bytes, tokens, n_clients = _build(cfg, shape, mesh,
                                                           pfels)
    n_params = T.param_count(T.init_shapes(cfg))
    counter = OpCounter(device="meta")
    at_start = counter.track(args)
    arg_storages = _storages(tree_leaves(list(args)))
    try:
        with counter:
            out = step(*args)
        outs = _storages(t for t in tree_leaves(list(out))
                         if isinstance(t, torch.Tensor))
        out_bytes = sum(-(-t.untyped_storage().nbytes() // ALLOC_ROUND)
                        * ALLOC_ROUND for k, t in outs.items()
                        if k not in arg_storages)
    finally:
        counter.close()
    build_s = time.perf_counter() - t0
    terms = roofline_terms({"flops": counter.flops,
                            "bytes accessed": counter.bytes},
                           {"total": counter.coll}, mesh.size)
    mf = model_flops(cfg.active_param_count_estimate(), tokens,
                     "train" if shape.kind == "train" else "serve")
    record = {
        "arch": arch, "shape": shape.name, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "per_device_batch": _rows_per_device(shape.global_batch, mesh),
        "n_clients": n_clients,
        "mesh": mesh.shape, "n_chips": mesh.size, "device": "meta",
        "n_layers": cfg.n_layers, "d_model": cfg.d_model, "dtype": cfg.dtype,
        "n_params": int(n_params), "step_kind": shape.kind,
        "grad_accum": pfels.grad_accum if shape.kind == "train" else None,
        "build_s": round(build_s, 2), "ops": counter.ops,
        "memory": {
            "argument_bytes": int(args_bytes),
            "argument_bytes_one_device": int(at_start),
            "output_bytes": int(out_bytes),
            "temp_bytes": int(counter.peak - at_start),
            "peak_bytes_per_device": int(counter.peak),
        },
        "cost": {"flops": counter.flops, "bytes": counter.bytes,
                 "coll": counter.coll},
        "kernels": counter.kernels,
        "roofline": terms,
        "model_flops_per_device": mf,
        "useful_flops_ratio": mf / counter.flops if counter.flops else 0.0,
        "fits": counter.peak <= HBM_BYTES,
        "note": NOTE,
    }
    if verbose:
        gb = 1e9
        mesh_name = "x".join(str(e) for e in mesh.extents)
        print(f"[{arch} x {shape.name} x {mesh_name}] "
              f"build={record['build_s']}s ops={counter.ops}"
              f" peak={counter.peak / gb:.2f}GB"
              f" args/dev={args_bytes / gb:.3f}GB"
              f" t_comp={terms['t_compute_s'] * 1e3:.2f}ms"
              f" t_mem={terms['t_memory_s'] * 1e3:.2f}ms"
              f" t_coll={terms['t_collective_s'] * 1e3:.2f}ms"
              f" dom={terms['dominant']}"
              f" useful={record['useful_flops_ratio']:.2f}"
              f" fits={record['fits']}", flush=True)
    return record


def dryrun_cohort(*, clients_per_round: int = 32, world: int = 1,
                  verbose: bool = True) -> dict:
    """One sharded FL round (``client_sharding="cohort"``) of BENCH_MLP
    with N = 1000 clients through the port's ``Trainer``, on the meta
    device (the round needs no host value): its ``d``, the cohort's
    (pod, data) shape on ``world`` ranks (``cohort_shape``) and the
    one-process round's peak. In one process the group has one shard;
    ``world`` ranks would each hold ``r / shards`` clients."""
    from repro_torch.configs.paper_models import BENCH_MLP
    from repro_torch.data import make_federated_classification
    from repro_torch.fl import Trainer
    from repro_torch.models import cnn

    dev = "meta"
    key = prng.PRNGKey(0, dev)
    t0 = time.perf_counter()
    params = cnn.init_cnn(key, BENCH_MLP, device=dev)
    x, y, _, _ = make_federated_classification(
        key, n_clients=1000, per_client=30, num_classes=10,
        image_shape=(1, 8, 8), device=dev)
    cfg = PFELSConfig(num_clients=1000, clients_per_round=clients_per_round,
                      local_steps=1, client_sharding="cohort")
    trainer = Trainer(cfg, lambda p, b: cnn.cnn_loss(p, BENCH_MLP, b),
                      params, device=dev)
    state = trainer.init(prng.PRNGKey(1, dev))
    counter = OpCounter(device=dev)
    at_start = counter.track(state, x, y)
    try:
        with counter:
            trainer.step(state, x, y)
    finally:
        counter.close()
    pod, data = cohort_shape(clients_per_round, world)
    record = {
        "kind": "cohort_round", "device": dev, "d": int(trainer.d),
        "clients_per_round": clients_per_round, "world": world,
        "mesh": {"pod": pod, "data": data}, "shards": pod * data,
        "clients_per_shard": clients_per_round // (pod * data),
        "build_s": round(time.perf_counter() - t0, 2), "ops": counter.ops,
        "memory": {"argument_bytes": int(at_start),
                   "temp_bytes": int(counter.peak - at_start),
                   "peak_bytes_per_device": int(counter.peak)},
        "cost": {"flops": counter.flops, "bytes": counter.bytes,
                 "coll": counter.coll},
        "note": "one process's round on the meta device (one shard); the "
                "shape is that of the cohort over `world` ranks",
    }
    if verbose:
        print(f"[cohort round r={clients_per_round} x {record['mesh']}] "
              f"build={record['build_s']}s"
              f" peak={counter.peak / 1e9:.3f}GB shards={pod * data}",
              flush=True)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cohort", action="store_true",
                    help="dry-run the sharded FL round (client_sharding="
                         "'cohort') instead of a model x shape combination")
    ap.add_argument("--cohort-r", type=int, default=32,
                    help="clients per round for --cohort")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--perf", action="store_true",
                    help="apply the reference's tuned variants "
                         "(PERF_VARIANTS)")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    if args.cohort:
        rec = dryrun_cohort(clients_per_round=args.cohort_r,
                            world=make_production_mesh(
                                multi_pod=args.multi_pod).size)
        path = os.path.join(args.out, f"cohort_round__r{args.cohort_r}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=2)
        print("cohort dry-run OK")
        return
    if args.all:
        jobs = [(a, s) for a in list_archs() for s in SHAPES]
    elif args.arch and args.shape:
        jobs = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, --all or --cohort")

    t0 = time.perf_counter()
    failures = []
    for arch, shape in jobs:
        try:
            rec = dryrun_one(arch, shape, multi_pod=args.multi_pod,
                             perf=args.perf)
            tag = "multipod" if args.multi_pod else "pod"
            if args.perf:
                tag += "_perf"
            path = os.path.join(args.out, f"{arch}__{shape}__{tag}.json")
            with open(path, "w") as f:
                json.dump(rec, f, indent=2)
        except Exception as e:  # report every combination, then fail
            traceback.print_exc()
            failures.append((arch, shape, repr(e)))
    if failures:
        print("FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print(f"dry-run OK: {len(jobs)} combination(s) in "
          f"{time.perf_counter() - t0:.1f}s")


if __name__ == "__main__":
    main()
