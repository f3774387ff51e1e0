"""Grid evaluation (``sincformer_tpu/evaluation/grid.py``, one process):
utterances × noises × SNRs × methods × the five metrics, checkpoint
discovery, the seed-99 utterance draw, per-noise tables, the grand summary
and the ``--json-out`` record.

Utterances are zero-padded to length buckets (multiples of 4000 samples),
so each (noise, SNR, bucket) cell is one batched enhancement call; metrics
are taken on the true lengths, in one device sweep (``batched.py``) when a
bucket's lengths are equal and by the host entry points otherwise. A
failed enhancement is printed and counted, never dropped silently. Every
pipeline of the port has ``enhance_batch``, so JAX's serial path for one
without it is not needed.

Scale-out, as in JAX: ``evaluate_grid(mesh=...)`` splits the metric
sweep's batch over a list of devices (one process), and
:func:`evaluate_grid_distributed` deals the (noise, SNR) cells to the
processes of a group and merges their parts.
"""

from __future__ import annotations

import inspect
import json
import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from sincformer_tpu_torch.config import AudioConfig, DataConfig
from sincformer_tpu_torch.data.audio import add_noise_at_snr, load_audio
from sincformer_tpu_torch.data.loader import (find_speech_files,
                                              load_noise_signals)
from sincformer_tpu_torch.evaluation.batched import metrics_batch
from sincformer_tpu_torch.evaluation.csii import compute_csii
from sincformer_tpu_torch.evaluation.ncm import compute_ncm
from sincformer_tpu_torch.evaluation.pesq import compute_pesq
from sincformer_tpu_torch.evaluation.ssnr import compute_ssnr
from sincformer_tpu_torch.evaluation.stoi import compute_stoi
from sincformer_tpu_torch.parallel import collectives
from sincformer_tpu_torch.parallel.distributed import (init_distributed,
                                                       is_primary,
                                                       merge_grid_results,
                                                       partition_grid_cells,
                                                       process_count,
                                                       process_index)

METRICS = ("stoi", "pesq", "ssnr", "csii", "ncm")
_METRIC_FNS = {"stoi": compute_stoi, "pesq": compute_pesq,
               "ssnr": compute_ssnr, "csii": compute_csii,
               "ncm": compute_ncm}


def discover_pipelines(model_dir: str,
                       names: Optional[Sequence[str]] = None,
                       device="cuda") -> Dict[str, object]:
    """Load the trained checkpoints found under ``model_dir`` on
    ``device``: the mask DNNs, DCSE and the flagship (``names`` restricts
    the kinds). Without a DCSE checkpoint of the port, a reference-format
    ``conformer_final.pt`` or ``best_conformer.pt`` is imported through
    ``DCSEPipeline.from_torch_checkpoint``, as the JAX grid does; every
    failure is printed and the kind left out."""
    from sincformer_tpu_torch.pipeline import (DCSEPipeline, DNNPipeline,
                                               SincformerPipeline)
    pipelines: Dict[str, object] = {}

    def _want(name):
        return names is None or name in names

    def _has(name):
        return os.path.isdir(os.path.join(model_dir, name))

    candidates = [(mt, f"dnn_{mt}_final", f"best_{mt}", mt,
                   lambda mt=mt: DNNPipeline(mask_type=mt, device=device,
                                             model_dir=model_dir))
                  for mt in ("pcirm", "opt_pcirm", "irm")]
    candidates += [
        ("conformer", "conformer_final", "best_conformer",
         "conformer (DCSE)", lambda: DCSEPipeline(device=device,
                                                  model_dir=model_dir)),
        ("sincformer", "sincformer_final", "best_sincformer",
         "sincformer (metacog)",
         lambda: SincformerPipeline(device=device, model_dir=model_dir))]
    for name, final, best, label, make in candidates:
        if not (_want(name) and (_has(final) or _has(best))):
            continue
        try:
            p = make()
            p.load_model()
            pipelines[name] = p
            print(f"  + Found trained model: {label}")
        except Exception as e:
            print(f"  x {name}: {e}")

    if _want("conformer") and "conformer" not in pipelines:
        for name in ("conformer_final.pt", "best_conformer.pt"):
            pt = os.path.join(model_dir, name)
            if os.path.exists(pt):
                try:
                    pipelines["conformer"] = \
                        DCSEPipeline.from_torch_checkpoint(
                            pt, model_dir=model_dir, device=device)
                    print(f"  + Imported reference checkpoint: {name}")
                    break
                except Exception as e:
                    print(f"  x {name}: {e}")
    return pipelines


def evaluate_grid(clean_signals: Sequence[np.ndarray],
                  noises: Dict[str, np.ndarray],
                  pipelines: Dict[str, object],
                  snr_levels: Optional[Sequence[float]] = None,
                  metrics: Sequence[str] = METRICS,
                  verbose: bool = True, bucket_quantum: int = 4000,
                  device="cuda", mesh: Optional[Sequence] = None) -> Dict:
    """results[noise][method][snr][metric] = [value per utterance], the
    methods being "noisy" and each pipeline's name.

    One enhancement call per (noise, SNR, length bucket), the DNN given the
    true ``lengths``; metrics through :func:`metrics_batch` on ``device``
    when a bucket's lengths are equal (and it holds more than one
    utterance), else through the host entry points. Every pipeline must
    have ``enhance_batch`` (JAX's serial path for one without it is not
    ported: every pipeline of the port has it).

    ``mesh``: a list of devices (e.g. every visible card) over which the
    metric sweep's device metrics are split in contiguous blocks, all
    queued before any is read back, as JAX shards the sweep over its
    mesh's "data" axis (:func:`metrics_batch`). A bucket that does not
    divide is padded cyclically (``np.resize``: a 3-utterance bucket on 8
    devices repeats it), and the padded rows are dropped from the results;
    the host metrics (PESQ) run once over the real rows."""
    snr_levels = list(snr_levels or DataConfig().snr_levels)
    fs = AudioConfig().sample_rate
    methods = ["noisy"] + list(pipelines.keys())
    serial = [n for n, p in pipelines.items()
              if not hasattr(p, "enhance_batch")]
    if serial:
        raise TypeError(f"pipelines without enhance_batch: {serial}")
    failures: Dict[str, int] = {}

    def _record_failure(method, noise_name, snr, exc):
        failures[method] = failures.get(method, 0) + 1
        print(f"  ! enhancement FAILED: method={method} noise={noise_name} "
              f"snr={snr}: {type(exc).__name__}: {exc}")

    def _metrics_for(clean_list, sig_list):
        if len({len(c) for c in clean_list}) == 1 and len(clean_list) > 1:
            vals = metrics_batch(np.stack(clean_list), np.stack(sig_list),
                                 metrics, fs=fs, device=mesh or device)
            return [{k: float(vals[k][i]) for k in metrics}
                    for i in range(len(clean_list))]
        out = []
        for c, s in zip(clean_list, sig_list):
            ml = min(len(c), len(s))
            out.append({k: float(_METRIC_FNS[k](c[:ml], s[:ml], device=device))
                        for k in metrics})
        return out

    buckets: Dict[int, List[int]] = {}
    for i, c in enumerate(clean_signals):
        q = int(np.ceil(len(c) / bucket_quantum) * bucket_quantum)
        buckets.setdefault(q, []).append(i)

    results: Dict = {}
    for noise_name, noise in noises.items():
        results[noise_name] = {m: {snr: {k: [] for k in metrics}
                                   for snr in snr_levels} for m in methods}
        for snr in snr_levels:
            for q, idxs in sorted(buckets.items()):
                cleans = [clean_signals[i] for i in idxs]
                lengths = [len(c) for c in cleans]
                noisy_b = np.stack(
                    [np.pad(add_noise_at_snr(c, noise, snr),
                            (0, q - len(c))) for c in cleans])
                outs = {"noisy": noisy_b}
                for name, pipe in pipelines.items():
                    try:
                        kw = {}
                        if "lengths" in inspect.signature(
                                pipe.enhance_batch).parameters:
                            kw["lengths"] = np.asarray(lengths)
                        outs[name] = np.asarray(
                            pipe.enhance_batch(noisy_b, **kw))
                    except Exception as e:
                        _record_failure(name, noise_name, snr, e)
                for method, sig_b in outs.items():
                    trimmed = [sig_b[j][:lengths[j]]
                               for j in range(len(idxs))]
                    cell = results[noise_name][method][snr]
                    for vals in _metrics_for(cleans, trimmed):
                        for k in metrics:
                            cell[k].append(vals[k])
        if verbose:
            print(f"  finished noise: {noise_name} "
                  f"(batched, {len(buckets)} bucket(s))")
    if failures:
        total = sum(failures.values())
        print(f"  !! {total} enhancement failure(s) during grid "
              f"evaluation — affected: "
              + ", ".join(f"{m} ({n}×)" for m, n in sorted(failures.items()))
              + ". Averages for these methods cover FEWER cells.")
    return results


def evaluate_grid_distributed(clean_signals: Sequence[np.ndarray],
                              noises: Dict[str, np.ndarray],
                              pipelines: Dict[str, object],
                              snr_levels: Optional[Sequence[float]] = None,
                              out_dir: Optional[str] = None,
                              **kwargs) -> Dict:
    """The grid over the processes of a group: the (noise, SNR) cells are
    dealt round-robin (``parallel.partition_grid_cells``), each process
    evaluates its sub-grid with :func:`evaluate_grid` (``kwargs``), writes
    its part to the shared ``out_dir``, waits at a barrier and merges every
    part (``merge_grid_results``), so each process returns the whole grid.
    A single process returns :func:`evaluate_grid`'s result exactly."""
    snr_levels = list(snr_levels or DataConfig().snr_levels)
    per_noise: Dict[str, List[float]] = {}
    for n, s in partition_grid_cells(list(noises), snr_levels):
        per_noise.setdefault(n, []).append(s)
    part: Dict = {}
    for n, snrs in per_noise.items():
        part.update(evaluate_grid(clean_signals, {n: noises[n]}, pipelines,
                                  snrs, **kwargs))
    if process_count() == 1:
        return part
    if not out_dir:
        raise ValueError("the grid over several processes needs a shared "
                         "out_dir")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"grid_part_{process_index()}.pkl"),
              "wb") as f:
        pickle.dump(part, f)
    collectives.barrier()
    parts = []
    for p in range(process_count()):
        with open(os.path.join(out_dir, f"grid_part_{p}.pkl"), "rb") as f:
            parts.append(pickle.load(f))
    return merge_grid_results(parts)


def _mean(vals):
    return float(np.mean(vals)) if vals else None


def print_grid_tables(results: Dict, snr_levels: Sequence[float],
                      metrics: Sequence[str] = METRICS):
    """Per-noise tables and the grand summary; returns the summary,
    {(method, metric): (mean, std)} over every cell."""
    noise_names = list(results.keys())
    methods = list(next(iter(results.values())).keys())

    for noise_name in noise_names:
        print(f"\n{'=' * 70}")
        print(f"  RESULTS — {noise_name} noise")
        print("=" * 70)
        for k in metrics:
            print(f"\n  {k.upper():<12}"
                  + "".join(f"{m:>12}" for m in methods))
            print("  " + "-" * (12 + 12 * len(methods)))
            for snr in snr_levels:
                row = f"  {snr:>8} dB "
                for m in methods:
                    v = _mean(results[noise_name][m][snr][k])
                    row += f"{v:>12.4f}" if v is not None else f"{'N/A':>12}"
                print(row)

    print(f"\n{'=' * 70}")
    print(f"  GRAND SUMMARY — averaged over {len(noise_names)} noise types")
    print("=" * 70)
    summary = {}
    for k in metrics:
        print(f"\n  {k.upper() + ' ↑':<12}"
              + "".join(f"{m:>14}" for m in methods))
        print("  " + "-" * (12 + 14 * len(methods)))
        for m in methods:
            all_vals: List[float] = []
            for noise_name in noise_names:
                for snr in snr_levels:
                    all_vals.extend(results[noise_name][m][snr][k])
            if all_vals:
                summary[(m, k)] = (float(np.mean(all_vals)),
                                   float(np.std(all_vals)))
        row = f"  {'Average':<12}"
        for m in methods:
            if (m, k) in summary:
                mu, sd = summary[(m, k)]
                row += f"  {mu:>7.4f}±{sd:.3f}"
            else:
                row += f"{'N/A':>14}"
        print(row)
    return summary


def eval_utterances(max_eval: int, synth_speech: str = "formant"
                    ) -> List[np.ndarray]:
    """The utterances scored: ``max_eval`` TIMIT files drawn with the
    seed-99 ``RandomState`` (those of at least 4 frames), or, without
    TIMIT, up to 8 synthetic utterances of 2 s ("formant": the fixed
    pattern; "varied": one randomised utterance per index, from seeds
    disjoint from the training corpus's) at seed-99 levels."""
    data = DataConfig()
    fs = AudioConfig().sample_rate
    files = find_speech_files()
    if files:
        rs = np.random.RandomState(data.eval_sample_seed)
        clean_signals = []
        for f in rs.choice(files, min(max_eval, len(files)),
                           replace=False).tolist():
            try:
                c = load_audio(f, fs)
            except Exception:
                continue
            if len(c) >= AudioConfig().frame_size * 4:
                clean_signals.append(c)
        return clean_signals
    print("  ! No TIMIT data — falling back to synthetic utterances"
          f" (speech={synth_speech})")
    rng = np.random.default_rng(data.eval_sample_seed)
    if synth_speech == "varied":
        from sincformer_tpu_torch.data.synthetic import \
            synthetic_speech_varied
        return [synthetic_speech_varied(2.0, seed=500_000 + i)
                * (0.7 + 0.6 * rng.random()) for i in range(min(max_eval, 8))]
    from sincformer_tpu_torch.data.synthetic import synthetic_speech
    return [synthetic_speech(2.0) * (0.7 + 0.6 * rng.random())
            for _ in range(min(max_eval, 8))]


def grid_differences(got: Dict, ref: Dict, method: str,
                     noise: str = "white") -> Dict[str, Dict]:
    """Per metric, between two ``--json-out`` records for ``method``: the
    absolute difference of the means over every cell ("mean"), and the
    largest difference of one utterance ("utterance") with its SNR and
    index ("where")."""
    out = {}
    cells_got = got["results"][noise][method]
    cells_ref = ref["results"][noise][method]
    for k in METRICS:
        rows = [(snr, i, a, b) for snr in cells_ref
                for i, (a, b) in enumerate(zip(cells_got[snr][k],
                                               cells_ref[snr][k]))]
        worst = max(rows, key=lambda r: abs(r[2] - r[3]))
        out[k] = {"mean": abs(float(np.mean([r[2] for r in rows]))
                              - float(np.mean([r[3] for r in rows]))),
                  "utterance": abs(worst[2] - worst[3]),
                  "where": f"{worst[0]} dB #{worst[1]}"}
    return out


def run_grid_evaluation(max_eval: int = 50, model_dir: Optional[str] = None,
                        metrics: Sequence[str] = METRICS,
                        distributed: bool = False, use_mesh: bool = False,
                        synth_noises: str = "white",
                        synth_speech: str = "formant",
                        json_out: Optional[str] = None, device="cuda"):
    """The ``evaluate`` verb: discover the models, draw the utterances and
    noises, evaluate on ``device``, print the tables; ``json_out`` writes
    every per-cell value, the protocol and the grand summary as JSON (the
    JAX package's layout). Returns the summary (None without models).

    ``use_mesh`` splits the metric sweep over every visible card (the
    ``mesh`` of :func:`evaluate_grid`; one card or the CPU: unsharded, as
    JAX on one device). ``distributed`` joins the process group first
    (``parallel.init_distributed`` over gloo: the processes exchange only a
    barrier and files) and deals the cells to the processes
    (:func:`evaluate_grid_distributed`); every process prints the merged
    tables and rank 0 alone writes ``json_out``."""
    if distributed:
        # before anything is loaded on the card: the process picks its
        # card (LOCAL_RANK) there
        init_distributed(backend="gloo", device=device)
    model_dir = model_dir or os.environ.get("SINCFORMER_MODEL_DIR",
                                            "saved_models")
    fs = AudioConfig().sample_rate
    print("=" * 70)
    print("  Speech Enhancement — Full Multi-Noise Evaluation (5 metrics)")
    print("=" * 70)

    pipelines = discover_pipelines(model_dir, device=device)
    if not pipelines:
        print("\n  No trained models found! Train first with:")
        print("    python -m sincformer_tpu_torch.cli train --pipeline agents")
        return None

    clean_signals = eval_utterances(max_eval, synth_speech)
    noises = load_noise_signals(fs, synth_fallback=synth_noises)
    snr_levels = list(DataConfig().snr_levels)
    print(f"\n  Evaluating {len(clean_signals)} utterances × "
          f"{len(noises)} noises × {len(snr_levels)} SNRs")
    print(f"  Methods: noisy, {', '.join(pipelines.keys())}")
    mesh = None
    if use_mesh:
        if torch.device(device).type == "cuda" \
                and torch.cuda.device_count() > 1:
            mesh = [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
            print(f"  Metric sweep sharded over {len(mesh)} cards")
        else:
            print("  --mesh requested but only one device is visible — "
                  "running unsharded")
    if distributed:
        print(f"  Distributed grid: process {process_index()} of "
              f"{process_count()}")
        results = evaluate_grid_distributed(
            clean_signals, noises, pipelines, snr_levels,
            out_dir=os.path.join(model_dir, "_distributed_eval"),
            metrics=metrics, device=device, mesh=mesh)
    else:
        results = evaluate_grid(clean_signals, noises, pipelines,
                                snr_levels, metrics, device=device,
                                mesh=mesh)
    summary = print_grid_tables(results, snr_levels, metrics)
    if json_out and is_primary():
        payload = {
            "protocol": {"max_eval": max_eval,
                         "n_utterances": len(clean_signals),
                         "noises": list(noises.keys()),
                         "snr_levels": snr_levels,
                         "synth_noises": synth_noises,
                         "synth_speech": synth_speech,
                         "model_dir": model_dir,
                         "ckpt_pref": os.environ.get(
                             "SINCFORMER_CKPT_PREF", "final"),
                         "methods": list(pipelines.keys())},
            "results": {nz: {m: {str(snr): {k: [float(v) for v in vals]
                                            for k, vals in by_m.items()}
                                 for snr, by_m in by_snr.items()}
                             for m, by_snr in by_method.items()}
                        for nz, by_method in results.items()},
            "summary": {f"{m}.{k}": [mu, sd]
                        for (m, k), (mu, sd) in summary.items()},
        }
        os.makedirs(os.path.dirname(os.path.abspath(json_out)),
                    exist_ok=True)
        with open(json_out, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"  Per-cell results + summary written to {json_out}")
    print(f"\n{'=' * 70}\n  Evaluation complete!\n{'=' * 70}")
    return summary
