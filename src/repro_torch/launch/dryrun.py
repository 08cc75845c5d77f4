"""Multi-pod dry run (counterpart of ``repro/launch/dryrun.py``).

For every (architecture x input-shape) cell, count one rank's train or
serve step on the production meshes:

    single-pod : (16, 16)      ("data", "model")     = 256 ranks
    multi-pod  : (2, 16, 16)   ("pod","data","model") = 512 ranks

The JAX package lowers and compiles the step for 512 host devices.  The
port runs its own step once, eagerly, over ``meta`` DTensors on a mesh of
torch's fake process group (``fake_world``: one process stands for rank 0
of the world, and collectives move no data), under
``cost_analysis.CostCounter``, and records the counted FLOPs, bytes,
collectives and memory with the three-term roofline
(``launch/cost_analysis.py``: an H100 SXM5's rates) in
experiments/torch_dryrun/<arch>__<shape>__<mesh>[__tag].json, with every
key of the JAX record and ``mesh_device``.  The mesh's device type is
``--mesh-device`` (``cuda`` by default, which needs a card; ``cpu`` runs
anywhere, and there DTensor's all-to-all is an all-gather and a chunk,
which the counter charges as the all-to-all).

Usage:
    python -m repro_torch.launch.dryrun --arch gemma_2b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both --mesh-device cpu
    python -m repro_torch.launch.dryrun --all --subprocess   # each cell in a fresh process
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "torch_dryrun")
N_DEVICES = {"single": 256, "multi": 512}


def _result_path(arch: str, shape: str, mesh_kind: str, tag: str = "") -> str:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    return os.path.join(RESULTS_DIR, f"{arch}__{shape}__{mesh_kind}{suffix}.json")


@contextlib.contextmanager
def fake_world(n: int):
    """torch's fake process group of ``n`` ranks, this process rank 0, for
    the block; destroyed on exit.  Refuses to start over an initialized
    group."""
    import torch.distributed as dist

    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("this torch has no fake process group "
                           "(torch.testing._internal.distributed.fake_pg)") from e
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized: the dry run needs its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _lower_for(cfg, mesh, shape_name, specs, *, microbatch=None):
    from repro_torch.configs import base as cb
    from repro_torch.launch import steps
    from repro_torch.optim import adamw

    kind = cb.SHAPES[shape_name]["kind"]
    if kind == "train":
        return steps.lower_train_step(cfg, mesh, adamw(1e-4), specs, microbatch=microbatch)
    return steps.lower_serve_step(cfg, mesh, specs,
                                  kind="prefill" if kind == "prefill" else "decode",
                                  fsdp_params=cfg.serve_fsdp)


def _depth_pair(cfg):
    """Two reduced depths for the affine per-layer cost fit (the JAX
    package's: the leading dense layers and the hybrid attention period
    kept whole).  XLA counts a scan body once, so the JAX dry run needs the
    fit; the eager count sees every layer, so the fit must give the direct
    full-depth count: ``extrapolated_costs`` is the check that it does."""
    if cfg.n_dense_layers:                       # deepseek: 3 dense + moe
        return cfg.n_dense_layers + 1, cfg.n_dense_layers + 2
    if cfg.family == "hybrid":                   # zamba2: shared attn every 6
        return cfg.hybrid_attn_every, 2 * cfg.hybrid_attn_every
    return 2, 4


def _with_depth(cfg, n):
    kw = {"n_layers": n}
    if cfg.n_encoder_layers:
        kw["n_encoder_layers"] = n               # whisper scales both stacks
    return cfg.replace(**kw)


def _measured_costs(compiled, n_dev):
    """(fp32 FLOPs, tensor-core FLOPs, bytes, wire bytes) of one rank."""
    from repro_torch.launch import cost_analysis as ca

    f = compiled.flops_by_class
    return (f.get("fp32", 0.0), f.get("tensor", 0.0),
            compiled.cost_analysis()["bytes accessed"],
            ca.collective_stats(compiled.collectives, n_dev).wire_bytes)


def extrapolated_costs(cfg, mesh, shape_name, *, n_dev) -> dict:
    """Affine-in-depth extrapolation of (flops, bytes, wire_bytes) from two
    un-microbatched shallow steps."""
    from repro_torch.configs import base as cb

    n_full = cfg.n_layers
    d1, d2 = _depth_pair(cfg)
    vals = {}
    for d in (d1, d2):
        c = _with_depth(cfg, d)
        specs = cb.input_specs(c, shape_name)
        vals[d] = _measured_costs(_lower_for(c, mesh, shape_name, specs).compile(), n_dev)
    slope = [(b - a) / (d2 - d1) for a, b in zip(vals[d1], vals[d2])]
    full = [v + s * (n_full - d1) for v, s in zip(vals[d1], slope)]
    return {
        "flops": full[0] + full[1], "bytes": full[2], "wire_bytes": full[3],
        "flops_by_class": {"fp32": full[0], "tensor": full[1]},
        "per_layer": {"flops": slope[0] + slope[1], "bytes": slope[2],
                      "wire_bytes": slope[3]},
        "depths_used": [d1, d2],
    }


def run_cell(arch: str, shape: str, mesh_kind: str, *, tag: str = "",
             overrides: dict | None = None, mesh_device: str = "cuda") -> dict:
    """Count one cell on a fake world of its mesh's size; returns the
    result record."""
    from repro_torch.configs import base as cb
    from repro_torch.launch import cost_analysis as ca
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import api

    t0 = time.time()
    cfg = cb.get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    sh = cb.SHAPES[shape]
    record: dict = {
        "arch": arch, "shape": shape, "mesh": mesh_kind, "tag": tag,
        "kind": sh["kind"], "seq_len": sh["seq_len"],
        "global_batch": sh["global_batch"], "status": "pending",
    }
    if shape == "long_500k" and not cfg.sub_quadratic:
        record["status"] = "skipped"
        record["reason"] = ("full-attention arch: long_500k requires "
                            "sub-quadratic attention (DESIGN.md §5)")
        return record
    record["mesh_device"] = mesh_device
    n_dev = N_DEVICES[mesh_kind]
    with fake_world(n_dev):
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device=mesh_device)
        specs = cb.input_specs(cfg, shape)
        tokens = sh["global_batch"] * (sh["seq_len"] if sh["kind"] != "decode" else 1)
        n_active = api.count_params(cfg, active_only=True)
        model_flops = (6 if sh["kind"] == "train" else 2) * n_active * tokens

        # full count: microbatched grad accumulation (the deployable memory
        # config); the extrapolation below runs un-microbatched
        microbatch = 8 if sh["kind"] == "train" else None
        record["microbatch"] = microbatch
        lowered = _lower_for(cfg, mesh, shape, specs, microbatch=microbatch)
        record["lower_s"] = round(time.time() - t0, 1)
        t1 = time.time()
        compiled = lowered.compile()
        record["compile_s"] = round(time.time() - t1, 1)
        mem = compiled.memory_analysis()
        print(f"[{arch}/{shape}/{mesh_kind}] memory_analysis:", mem)
        cost = compiled.cost_analysis()
        print(f"[{arch}/{shape}/{mesh_kind}] cost_analysis: flops={cost['flops']:.3e}"
              f" bytes={cost['bytes accessed']:.3e}")
        terms = ca.roofline(compiled, total_devices=n_dev, model_flops=model_flops)
        record.update(terms.as_dict())
        record["raw_compiled"] = {  # the full-depth step as counted
            "flops_per_device": terms.flops_per_device,
            "bytes_per_device": terms.bytes_per_device,
            "wire_bytes_per_device": terms.wire_bytes_per_device,
            "flops_by_class": compiled.flops_by_class,
        }
        record["binary_matmul"] = dict(compiled.counter.binary)
        ext = extrapolated_costs(cfg, mesh, shape, n_dev=n_dev)
    record["extrapolation"] = ext
    record["flops_per_device"] = ext["flops"]
    record["flops_by_class"] = ext["flops_by_class"]
    record["bytes_per_device"] = ext["bytes"]
    record["wire_bytes_per_device"] = ext["wire_bytes"]
    record["compute_s"] = ca.compute_seconds(ext["flops_by_class"])
    record["memory_s"] = ext["bytes"] / ca.HBM_BW
    record["collective_s"] = ext["wire_bytes"] / ca.LINK_BW
    terms3 = {"compute": record["compute_s"], "memory": record["memory_s"],
              "collective": record["collective_s"]}
    record["bound"] = max(terms3, key=terms3.get)
    if record["flops_per_device"]:
        record["model_flops_ratio"] = model_flops / (record["flops_per_device"] * n_dev)
    record["n_devices"] = n_dev
    record["n_params"] = api.count_params(cfg)
    record["n_active_params"] = n_active
    record["status"] = "ok"
    record["total_s"] = round(time.time() - t0, 1)
    return record


def run_and_save(arch: str, shape: str, mesh_kind: str, *, tag: str = "",
                 overrides: dict | None = None, mesh_device: str = "cuda") -> dict:
    try:
        record = run_cell(arch, shape, mesh_kind, tag=tag, overrides=overrides,
                          mesh_device=mesh_device)
    except Exception as e:  # noqa: BLE001 — failures are recorded, not raised
        record = {"arch": arch, "shape": shape, "mesh": mesh_kind, "tag": tag,
                  "mesh_device": mesh_device, "status": "error",
                  "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-3000:]}
    path = _result_path(arch, shape, mesh_kind, tag)
    with open(path, "w") as f:
        json.dump(record, f, indent=1, default=str)
    print(f"[{arch}/{shape}/{mesh_kind}] -> {record['status']} ({path})")
    return record


def main(argv=None) -> None:
    from repro_torch.configs import base as cb

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--subprocess", action="store_true",
                    help="count each cell in a fresh process")
    ap.add_argument("--mesh-device", default="cuda", choices=["cuda", "cpu"],
                    help="the device type of the fake mesh (cuda needs a card)")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s) for a in cb.ARCH_IDS for s in cb.cells(cb.get_config(a))]
        # also record the documented skips
        cells += [(a, "long_500k") for a in cb.ARCH_IDS
                  if "long_500k" not in cb.cells(cb.get_config(a))]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    failures = 0
    for arch, shape in cells:
        for mesh_kind in meshes:
            path = _result_path(arch, shape, mesh_kind, args.tag)
            if os.path.exists(path) and not args.force:
                with open(path) as f:
                    if json.load(f).get("status") in ("ok", "skipped"):
                        print(f"[{arch}/{shape}/{mesh_kind}] cached — skip")
                        continue
            if args.subprocess:
                rc = subprocess.call(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", arch, "--shape", shape, "--mesh", mesh_kind,
                     "--mesh-device", args.mesh_device]
                    + (["--force"] if args.force else [])
                    + (["--tag", args.tag] if args.tag else []),
                    env=dict(os.environ))
                if rc:
                    failures += 1
            else:
                rec = run_and_save(arch, shape, mesh_kind, tag=args.tag,
                                   mesh_device=args.mesh_device)
                if rec["status"] == "error":
                    failures += 1
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
