"""CLI: inspect, time, quantize, convert and serve a model file (the port of
``rten_tpu/cli.py``; rten-cli, rten-cli/src/main.rs:39-108,296-340).

Prints the IO schema, synthesizes random inputs honoring --size/--range,
times `-n` iterations (mean/stddev), optionally profiles per op, feeds and
checks tensors from .npy/.npz/.safetensors files, quantizes (int8 dynamic
or int4 weight-only), saves the result (.rtpu or .rten), and serves a
static-cache LM over HTTP. It runs on the CUDA card; ``--device cpu`` runs
the plain versions of the kernels on the CPU instead. Without a card and
without ``--device cpu`` it raises.

Usage: python -m rten_tpu_torch MODEL [options]
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .dtypes import DataType
from .model import Model, ModelOptions


def _parse_size_spec(specs: List[str]) -> Dict[str, int]:
    """--size dim_name=N (repeatable)."""
    out = {}
    for spec in specs or []:
        name, _, val = spec.partition("=")
        if not val:
            raise SystemExit(f"--size expects name=N, got {spec!r}")
        out[name] = int(val)
    return out


def _gen_input(name, dtype, shape, dim_sizes, rng, lo, hi):
    resolved = []
    for d in shape or ():
        if isinstance(d, int):
            resolved.append(d)
        elif isinstance(d, str) and d in dim_sizes:
            resolved.append(dim_sizes[d])
        else:
            # Default dynamic dims like the reference CLI: 1.
            resolved.append(dim_sizes.get("*", 1))
    dtype = dtype or DataType.Float
    if dtype is DataType.Float:
        arr = rng.uniform(lo, hi, resolved).astype(np.float32)
    elif dtype is DataType.BFloat16:
        arr = torch.from_numpy(rng.uniform(lo, hi, resolved).astype(np.float32)).bfloat16()
    elif dtype is DataType.Bool:
        arr = rng.random(resolved) > 0.5
    else:
        arr = rng.integers(int(lo), max(int(hi), int(lo) + 1), resolved).astype(
            dtype.np_dtype
        )
    return arr


def quantize_model(model: Model, kind: str) -> None:
    """Quantize a loaded model's graph in place: "int8" (dynamic int8; the
    MatMulIntegerToFloat weights then prepacked, as the optimizer prepacks
    them, which pads an N the int8 kernel cannot take, such as a 50257-wide
    lm_head) or "int4" (weight-only); then drop the replaced constants."""
    from .optimize import eliminate_dead_constants, prepack_int8_weights
    from .quantize_pass import quantize_dynamic, quantize_weight_only_int4

    if kind == "int8":
        quantize_dynamic(model.graph)
        prepack_int8_weights(model.graph)
    else:
        quantize_weight_only_int4(model.graph)
    eliminate_dead_constants(model.graph)
    model.executor.invalidate_weights()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="rten_tpu_torch",
        description="Inspect, benchmark and serve ONNX, .rten and .rtpu models on a CUDA card",
    )
    from . import __version__

    ap.add_argument("model", help="path to .onnx, .rten or .rtpu model")
    ap.add_argument("-V", "--version", action="version",
                    version=f"rten_tpu_torch {__version__}")
    ap.add_argument("--device", help="device to run on (default: the CUDA card; "
                                     "'cpu' runs the kernels' plain versions)")
    ap.add_argument("-n", "--iters", type=int, default=1, help="timed iterations")
    ap.add_argument("--no-optimize", action="store_true", help="skip graph optimizer")
    ap.add_argument("--profile", "-p", action="store_true",
                    help="per-op profile (the device synchronized after each op)")
    ap.add_argument("--size", action="append", metavar="DIM=N",
                    help="size for a named dynamic dim (repeatable; DIM=* sets default)")
    ap.add_argument("--range", default="0:1", metavar="LO:HI",
                    help="value range for generated float inputs")
    ap.add_argument("--inputs", help="feed inputs from .npz/.safetensors (by name)")
    ap.add_argument("--check-outputs", dest="check_outputs",
                    help="compare outputs against .npz/.safetensors goldens")
    ap.add_argument("--save-outputs", dest="save_outputs",
                    help="write outputs to .npz/.safetensors")
    ap.add_argument("--print", dest="print_outputs", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("-q", "--quiet", action="store_true")
    ap.add_argument("--eager", action="store_true",
                    help="accepted for the JAX CLI's sake: the port always runs eagerly")
    ap.add_argument("--infer-shapes", dest="infer_shapes", action="store_true",
                    help="run symbolic shape inference and print value shapes")
    ap.add_argument("--quantize", choices=["int8", "int4"],
                    help="int8 dynamic or int4 weight-only quantization")
    ap.add_argument("--save-model", dest="save_model", metavar="OUT",
                    help="write the optimized/quantized model (.rtpu, or "
                         ".rten for the reference-compatible container)")
    ap.add_argument("--serve", type=int, metavar="PORT",
                    help="serve a static-cache LM graph over HTTP "
                         "(POST /generate, GET /health|/stats|/metrics); "
                         "model must have input_ids/past_lens/position_ids "
                         "inputs and a next_token output")
    ap.add_argument("--slots", type=int, default=8,
                    help="serving: concurrent decode slots")
    ap.add_argument("--steps-per-dispatch", type=int, default=8,
                    help="serving: fused on-device decode steps per dispatch")
    ap.add_argument("--prefill-bucket", type=int, default=64,
                    help="serving: prompt-length bucket size")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    model = Model.load_file(
        args.model, ModelOptions(optimize=not args.no_optimize), device=args.device
    )
    if args.quantize:
        quantize_model(model, args.quantize)
    if args.save_model:
        model.save(args.save_model)
        if not args.quiet:
            print(f"saved {args.save_model}")
    load_s = time.perf_counter() - t0

    if not args.quiet:
        print(f"loaded {args.model} in {load_s * 1e3:.0f} ms on {model.device}")
        print("inputs:")
        for name, dtype, shape in model.input_info():
            print(f"  {name}: {dtype.value if dtype else '?'} {list(shape) if shape else '?'}")
        print(f"outputs: {', '.join(model.output_names())}")
        if model.metadata:
            print(f"metadata: {model.metadata}")

    if args.serve is not None:
        g = model.graph
        for need in ("input_ids", "past_lens", "position_ids"):
            if g.find_node(need) is None:
                print(f"--serve needs a static-cache LM graph with a "
                      f"'{need}' input (build via models/*.py "
                      f"build_graph_static_cache and --save-model)")
                return 2
        cache0 = next(
            (g.nodes[n] for n in g.input_ids
             if g.node_name(n).startswith("past_key_values.")), None,
        )
        if cache0 is None:
            print("--serve: graph declares no past_key_values.* caches")
            return 2
        capacity = int(cache0.shape[2])
        from .serving import ContinuousBatchingEngine
        from .serving.http_server import serve as http_serve

        engine = ContinuousBatchingEngine(
            model, n_layer=0, n_head=0, head_dim=0,
            slots=args.slots, capacity=capacity,
            prefill_bucket=args.prefill_bucket,
            greedy_on_device=g.find_node("next_token") is not None,
            steps_per_dispatch=args.steps_per_dispatch,
        )
        if not args.quiet:
            print(f"serving on 127.0.0.1:{args.serve} "
                  f"(slots={args.slots}, capacity={capacity}, "
                  f"k={args.steps_per_dispatch})", flush=True)
        http_serve(engine, port=args.serve)
        return 0

    if args.infer_shapes:
        from .shape_inference import infer_shapes

        info = infer_shapes(model.graph)
        for nid, op_node in model.graph.operators():
            for out in op_node.outputs:
                dt, sh = info.get(out, (None, None))
                print(
                    f"  {model.graph.node_name(out)}: "
                    f"{dt.value if dt else '?'} {list(sh) if sh else '?'}"
                )
        return 0

    dim_sizes = _parse_size_spec(args.size)
    lo, hi = (float(x) for x in args.range.split(":"))
    rng = np.random.default_rng(args.seed)

    feed = {}
    if args.inputs:
        from .serialize import read_tensors

        provided = read_tensors(args.inputs)
    else:
        provided = {}
    for name, dtype, shape in model.input_info():
        if name in provided:
            feed[name] = provided[name]
        else:
            feed[name] = _gen_input(name, dtype, shape, dim_sizes, rng, lo, hi)

    if args.profile:
        g = model.graph
        nid_feed = {g.find_node(k): v for k, v in feed.items()}
        outputs, prof = model.executor.profile_run(nid_feed, g.output_ids)
        print(prof.report(by_shape=False))
    else:
        durations = []
        outputs = None
        for _ in range(max(args.iters, 1)):
            t0 = time.perf_counter()
            outputs = model.run(feed)
            if model.device.type == "cuda":
                torch.cuda.synchronize(model.device)
            durations.append(time.perf_counter() - t0)
        if not args.quiet:
            if len(durations) > 1:
                steady = durations[1:]
                mean = statistics.mean(steady)
                std = statistics.pstdev(steady)
                print(
                    f"first (uploads the weights) {durations[0] * 1e3:.2f} ms; then "
                    f"mean {mean * 1e3:.3f} ms, stddev {std * 1e3:.3f} ms "
                    f"over {len(steady)} iters"
                )
            else:
                print(f"run took {durations[0] * 1e3:.2f} ms (includes the weights' upload)")

    named_outputs = {}
    for name, o in zip(model.output_names(), outputs):
        o = o.detach().cpu()
        named_outputs[name] = (o.float() if o.dtype == torch.bfloat16 else o).numpy()
    if args.print_outputs:
        for name, val in named_outputs.items():
            print(f"{name} {val.shape} {val.dtype}:\n{val}")
    if args.save_outputs:
        from .serialize import write_tensors

        write_tensors(args.save_outputs, named_outputs)
    if args.check_outputs:
        from .serialize import read_tensors

        golden = read_tensors(args.check_outputs)
        ok = True
        for name, want in golden.items():
            got = named_outputs.get(name)
            if got is None:
                print(f"MISSING output {name}")
                ok = False
                continue
            if not np.allclose(got, want, rtol=1e-3, atol=1e-4):
                err = np.max(np.abs(got.astype(np.float64) - want.astype(np.float64)))
                print(f"MISMATCH {name}: max abs err {err}")
                ok = False
            else:
                print(f"OK {name}")
        return 0 if ok else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
