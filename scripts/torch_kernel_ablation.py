"""What holds the split-TF32 kernels K1, K3 and K5 back, measured by
removing parts of them in turn, on one CUDA card.

    python3 scripts/torch_kernel_ablation.py [--out ablation.json]
        [--kernels k1,k3,k5] [--k5-baseline path/to/conv_gn.cu]

Builds edited copies of ``sincformer_tpu_torch/csrc/fused_ffn.cu`` (K3),
``speech_attention.cu`` (K1) and ``conv_gn.cu`` (K5) with ``nvcc`` (one
process each, all started together) into
``sincformer_tpu_torch/_build/ablation/`` and times each beside the kernel
as committed and the library call, from CUDA-graph replays (device time),
at the main path's shapes:

  * K3: ``no_product_a`` (the three mma of h = xn . W1 removed),
    ``no_product_b`` (those of y += h . W2), ``no_weight_copies`` (W1 and W2
    never copied to shared memory), ``product_a_1xtf32`` (h = xn . W1 by
    the single product hi.hi), ``cvt_rounding`` (TF32 rounding by
    ``cvt.rna.tf32.f32`` instead of two integer operations);
  * K1: ``cvt_rounding``;
  * K5, at the JAX docstring's call site (16, 32,000, 64 -> 128, k=7, s=2)
    and the flagship block's shape (16, 400, 256 -> 256, k=7, s=1):
    ``no_mma`` (the tensor-core products removed), ``conv_only`` (the
    statistics merge and the normalise kernel not launched), ``1xtf32``
    (each product as the single TF32 product hi.hi), ``no_split`` (the
    staged window and w not split into hi and lo), ``no_staging`` (nothing
    copied into shared memory), and, with ``--k5-baseline``, another
    ``conv_gn.cu`` with the same C interface built as it is (the CUDA-core
    kernel of an earlier commit, unpacked with ``git archive``).

K3 is also timed on the inputs that the fused DCSE model (seeded weights)
gives its eight calls in a 60 s request, beside random values of the same
shape.

A variant that drops work gives wrong numbers; only its time is read. Every
edit is checked to apply, so a change to a kernel's source that moves the
edited lines fails here instead of timing the unedited kernel. Needs a CUDA
device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CVT = ('  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));\n'
       '  return r;')
INT_ROUND = "  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;"
PRODUCT_A = ("          mma(small[j], al, bh);\n"
             "          mma(small[j], ah, bl);\n"
             "          mma(big[j], ah, bh);\n")
PRODUCT_B = "for (int i = 0; i < 2; ++i) mma3(y[i][j], ah[i], al[i], bh, bl);"
W1_COPIES = "i < D * (kFC / 4); i += kThreads"
W2_COPIES = "i < kFC * (D / 4); i += kThreads"
K5_MMA = "mma3(acc[mt][nt], ah[mt], al[mt], bh, bl);"
K5_MMA1 = "tf32x3::mma(acc[mt][nt], ah[mt], bh);"
K5_STATS = ("  err = cudaGetLastError();\n  if (err != cudaSuccess) return (int)err;"
            "\n  stats_kernel<<<")
K5_STOP = "  return (int)cudaGetLastError();\n  stats_kernel<<<"
K5_SPLIT_X = "i < n_rows * kKC; i += kThreads"
K5_SPLIT_W = "i < kt * kKC * kTN; i += kThreads"
K5_STAGE_X = "phase < nph; ++phase"
K5_STAGE_W = "i < kt * kKC * (kTN / 4); i += kThreads"

# name -> (kernel source, [(old, new) edits of the source], header edit)
VARIANTS = {
    "k3": ("fused_ffn", [], None),
    "k3_no_product_a": ("fused_ffn", [(PRODUCT_A, "")], None),
    "k3_no_product_b": ("fused_ffn", [(PRODUCT_B, "")], None),
    "k3_no_weight_copies": ("fused_ffn", [
        (W1_COPIES, "i < 0; i += kThreads"),
        (W2_COPIES, "i < 0; i += kThreads")], None),
    "k3_product_a_1xtf32": ("fused_ffn", [(PRODUCT_A,
                                           "          mma(big[j], ah, bh);\n")],
                            None),
    "k3_cvt_rounding": ("fused_ffn", [], (INT_ROUND, CVT)),
    "k1": ("speech_attention", [], None),
    "k1_cvt_rounding": ("speech_attention", [], (INT_ROUND, CVT)),
    "k5": ("conv_gn", [], None),
    "k5_no_mma": ("conv_gn", [(K5_MMA, ";")], None),
    "k5_conv_only": ("conv_gn", [(K5_STATS, K5_STOP)], None),
    "k5_1xtf32": ("conv_gn", [(K5_MMA, K5_MMA1)], None),
    "k5_no_split": ("conv_gn", [(K5_SPLIT_X, "i < 0; i += kThreads"),
                                (K5_SPLIT_W, "i < 0; i += kThreads")], None),
    "k5_no_staging": ("conv_gn", [(K5_STAGE_X, "phase < 0; ++phase"),
                                  (K5_STAGE_W, "i < 0; i += kThreads")],
                      None),
}


def edited(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"edit does not apply once: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_variants(out_dir: str, kernels, k5_baseline=None) -> dict:
    from sincformer_tpu_torch.ops import build
    os.makedirs(out_dir, exist_ok=True)
    variants = {name: v for name, v in VARIANTS.items()
                if name.split("_")[0] in kernels}
    procs = {}
    for name, (src, edits, header) in variants.items():
        vdir = os.path.join(out_dir, name)
        os.makedirs(vdir, exist_ok=True)
        for fname, text in build._sources(src).items():
            text = text.decode()
            if fname == f"{src}.cu":
                text = edited(text, edits)
            elif header is not None:
                text = edited(text, [header])
            with open(os.path.join(vdir, fname), "w") as f:
                f.write(text)
        procs[name] = os.path.join(vdir, f"{src}.cu")
    if k5_baseline:
        procs["k5_baseline"] = os.path.abspath(k5_baseline)
    running = {}
    for name, source in procs.items():
        lib = os.path.join(out_dir, f"lib{name}.so")
        running[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", lib, source],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in running.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(lib)
        if name.startswith("k1"):
            fn = fn.speech_attention_fwd
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
                ctypes.c_float, ctypes.c_void_p]
        elif name.startswith("k5"):
            fn = fn.conv_gn_fwd
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        else:
            fn = fn.fused_ffn_fwd
            fn.argtypes = [ctypes.c_void_p] * 8 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def time_k5(fns: dict, g, card: str) -> dict:
    """K5's variants at the call site and the flagship block's shape, in
    turns with the library chain (conv1d f32 without TF32, group_norm,
    gelu)."""
    import torch.nn.functional as F

    from chip_smoke import graph_ms
    from sincformer_tpu_torch.ops.conv_gn import _same_pads
    result = {}
    for name, (bsz, t, cin, cout, k, s) in (
            ("call site", (16, 32000, 64, 128, 7, 2)),
            ("flagship block", (16, 400, 256, 256, 7, 1))):
        def r(*shape, scale=1.0):
            return torch.randn(*shape, device="cuda", generator=g) * scale
        x, w = r(bsz, t, cin), r(k, cin, cout, scale=0.1)
        b, beta = r(cout, scale=0.1), r(cout, scale=0.1)
        gamma = 1.0 + r(cout, scale=0.1)
        t_out, pad_l, pad_r = _same_pads(t, k, s)
        n_tiles = -(-t_out // 64)
        out = torch.empty(bsz, t_out, cout, device="cuda")
        partial = torch.empty(bsz, n_tiles, cout, 2, device="cuda")
        stats = torch.empty(bsz, 16, 2, device="cuda")
        w_oik = w.permute(2, 1, 0).contiguous()

        def library():
            y = F.conv1d(F.pad(x.transpose(1, 2), (pad_l, pad_r)), w_oik, b,
                         stride=s)
            return F.gelu(F.group_norm(y, 16, gamma, beta, 1e-6),
                          approximate="tanh").transpose(1, 2)
        row = {"library": graph_ms(library, 10)}
        for vname, fn in fns.items():
            if not vname.startswith("k5"):
                continue

            def call(fn=fn):
                err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                         gamma.data_ptr(), beta.data_ptr(), None,
                         out.data_ptr(), partial.data_ptr(), stats.data_ptr(),
                         bsz, t, cin, cout, k, s, pad_l, t_out, 16, 1e-6, 1,
                         torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
            row[vname] = graph_ms(call, 10)
        row["library_2"] = graph_ms(library, 10)
        result[name] = row
        print(f"[k5] {name} ({bsz}, {t}, {cin}->{cout}, k={k}, s={s}): "
              + ", ".join(f"{k_} {v:.4f} ms" for k_, v in row.items())
              + f" on {card}", flush=True)
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--kernels", default="k1,k3,k5",
                    help="which kernels' variants to build and time")
    ap.add_argument("--k5-baseline", default=None,
                    help="another conv_gn.cu to time beside K5's variants")
    args = ap.parse_args()
    kernels = set(args.kernels.split(","))
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import torch.nn.functional as F

    from chip_smoke import graph_ms
    from sincformer_tpu_torch.ops import build
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = build_variants(os.path.join(build.BUILD_DIR, "ablation"), kernels,
                         args.k5_baseline)
    g = torch.Generator(device="cuda").manual_seed(0)
    result = {"card": card, "k3": {}, "k1": {}}
    if "k5" in kernels:
        torch.backends.cudnn.allow_tf32 = False
        result["k5"] = time_k5(fns, g, card)

    if "k3" in kernels:
        for m in (25664, 6416, 1):
            d, f = 256, 1024

            def r(*shape, scale=1.0):
                return torch.randn(*shape, device="cuda", generator=g) * scale
            x, ln_g, ln_b, w1, b1, w2, b2 = a = (
                r(m, d), 1.0 + r(d, scale=0.1), r(d, scale=0.1),
                r(d, f, scale=d ** -0.5), r(f, scale=0.1),
                r(f, d, scale=f ** -0.5), r(d, scale=0.1))
            out = torch.empty_like(x)
            w1_oi, w2_oi = w1.t().contiguous(), w2.t().contiguous()

            def library():
                xn = F.layer_norm(x, (d,), ln_g, ln_b, 1e-6)
                return x + 0.5 * F.linear(F.silu(F.linear(xn, w1_oi, b1)), w2_oi,
                                          b2)
            row = {"library": graph_ms(library, 20)}
            for name, fn in fns.items():
                if not name.startswith("k3"):
                    continue

                def call(fn=fn):
                    err = fn(*(t.data_ptr() for t in a), out.data_ptr(), m, d, f,
                             torch.cuda.current_stream().cuda_stream)
                    if err != 0:
                        raise RuntimeError(f"launch failed: CUDA error {err}")
                row[name] = graph_ms(call, 20)
            result["k3"][f"rows={m}"] = row
            print(f"[k3] rows={m} d={d} d_ff={f}: " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in row.items()) + f" on {card}",
                  flush=True)

        # K3 on the inputs that the fused DCSE model gives it in a 60 s request
        # (16 windows of 401 frames; seeded weights, as in chip_smoke.py),
        # against the same shapes filled with random values
        import numpy as np

        import sincformer_tpu_torch as port
        from sincformer_tpu_torch.models import conformer
        from sincformer_tpu_torch.ops.fused_ffn import fused_ffn
        from sincformer_tpu_torch.serve import StreamingEnhancer
        model = port.SpeechEnhancer(port.DCSEConfig(fused_ffn=True)).init_params(
            torch.Generator().manual_seed(0))
        pipe = port.DCSEPipeline(model, device="cuda")
        calls = []

        def recording(*call_args):
            calls.append(tuple(t.clone() for t in call_args))
            return fused_ffn(*call_args)
        pcm60 = np.round(np.random.default_rng(1).standard_normal(480000)
                         * 3000).clip(-32768, 32767).astype(np.int16)
        conformer.fused_ffn = recording
        try:
            StreamingEnhancer(pipe, pipelined=False).enhance(pcm60)
        finally:
            conformer.fused_ffn = fused_ffn
        model_ms = [graph_ms(lambda c=c: fused_ffn(*c), 20) for c in calls]
        x0 = calls[0][0]
        random_x = (torch.randn(x0.shape, device="cuda", generator=g),
                    *calls[0][1:])
        result["k3_model_inputs"] = {
            "rows": x0.numel() // x0.shape[-1], "calls": model_ms,
            "first_call_random_x": graph_ms(lambda: fused_ffn(*random_x), 20)}
        print(f"[k3] the fused DCSE model's {len(calls)} feed-forward calls of a "
              f"60 s request ({tuple(x0.shape)}): "
              + ", ".join(f"{t:.4f}" for t in model_ms) + " ms; the first with "
              f"random x {result['k3_model_inputs']['first_call_random_x']:.4f} "
              f"ms on {card}", flush=True)

    if "k1" in kernels:
        sdpa = torch.nn.functional.scaled_dot_product_attention
        for b, t in ((4, 400), (16, 401)):
            h, dh = 4, 64
            q, k, v = (torch.randn(b, t, h, dh, device="cuda", generator=g)
                       for _ in range(3))
            qt, kt, vt = (y.transpose(1, 2).contiguous() for y in (q, k, v))
            row = {"library": graph_ms(lambda: sdpa(qt, kt, vt), 50)}
            for name, fn in fns.items():
                if not name.startswith("k1"):
                    continue

                def call(fn=fn):
                    out = torch.empty_like(q)
                    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                             out.data_ptr(), b, t, h, dh, dh ** -0.5,
                             torch.cuda.current_stream().cuda_stream)
                    if err != 0:
                        raise RuntimeError(f"launch failed: CUDA error {err}")
                row[name] = graph_ms(call, 50)
            result["k1"][f"B={b},T={t}"] = row
            print(f"[k1] B={b} T={t} H={h} dh={dh}: " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in row.items()) + f" on {card}",
                  flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
