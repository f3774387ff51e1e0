"""Long-form, many-file and live-stream enhancement
(``sincformer_tpu/serve.py``).

  * :class:`StreamingEnhancer` - overlap-add inference in fixed windows with
    a linear cross-fade: audio of any length with a constant device
    footprint. :meth:`StreamingEnhancer.enhance_many` batches many short
    utterances by padded length. :func:`enhance_long` is the one-call form.
  * :class:`OnlineEnhancer` - causal enhancement with a bounded algorithmic
    latency; :class:`OnlineEnhancerPool` advances many such streams with one
    batched forward per step.

``StreamingEnhancer.enhance`` has three paths, as in the JAX package:

  * the **whole-file device path**, for a pipeline with ``enhance_tensor``
    (both pipelines of ``pipeline.py``): the signal goes up once, is framed
    into windows on the device, groups of ``chunk_batch`` windows go through
    the pipeline, and the cross-fade weighting, the scatter-free overlap-add
    and the optional int16 quantization happen on the device; the result
    comes down once;
  * the **segmented device path** (``pipelined=True``, or by default from
    three segments on): windows are framed on the host and cross the link
    segment by segment through pinned buffers on copy streams, so that
    segment s computes while s+1 uploads and s-1 downloads; each segment
    returns its weighted overlap-add numerator and the host adds the seams;
  * the **host path**, for any object with ``enhance_signal`` and optionally
    ``enhance_batch``: windows are cut, enhanced in groups and overlap-added
    with numpy.

A pipeline with ``enhance_tensor`` never falls to the host path because a
device step failed: an error there is raised.
"""

from __future__ import annotations

import collections
import contextlib
import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from sincformer_tpu_torch.utils.signal import (float_to_pcm, frame_signal,
                                               overlap_add, pcm_to_float)


class StreamingEnhancer:
    """Wrap a pipeline into a constant-memory long-form enhancer.

    Args:
        pipeline: object with ``enhance_signal(np.ndarray) -> np.ndarray``
            and optionally ``enhance_batch((B, N)) -> (B, N)``; with
            ``enhance_tensor`` and ``device`` (DCSEPipeline,
            SincformerPipeline) it takes the device paths.
        window: samples per window (default 4 s at 8 kHz).
        overlap: cross-fade length in samples.
        chunk_batch: most windows enhanced per forward pass (bounds device
            memory for hours-long inputs).
        device_ola: None = the device paths when the pipeline has
            ``enhance_tensor``; False = always the host path.
        pipelined: None = the segmented path from three segments on, False
            = always the whole-file path, True = always segmented.
        transfer_depth: segments whose upload may run ahead of the compute
            on the segmented path; the segments in flight are bounded by it.
    """

    def __init__(self, pipeline, window: int = 32000, overlap: int = 1600,
                 chunk_batch: int = 64, device_ola: Optional[bool] = None,
                 pipelined: Optional[bool] = None, transfer_depth: int = 2):
        if not overlap < window // 2:
            raise ValueError(f"overlap={overlap} must be under half the "
                             f"window ({window})")
        self.pipeline = pipeline
        self.window = window
        self.overlap = overlap
        self.chunk_batch = chunk_batch
        ramp = np.linspace(0.0, 1.0, overlap, dtype=np.float32)
        self._fade_in = ramp
        self._fade_out = 1.0 - ramp
        self.device_ola = device_ola
        self.pipelined = pipelined
        self.transfer_depth = max(1, transfer_depth)

    # ── internals ───────────────────────────────────────────────────────

    def _has_device_path(self) -> bool:
        return (self.device_ola is not False
                and hasattr(self.pipeline, "enhance_tensor"))

    def _window_weights(self, idx: torch.Tensor, ends_before: torch.Tensor,
                        live: torch.Tensor) -> torch.Tensor:
        """(C, window) cross-fade weights on the device: fade-in on every
        window but the file's first (``idx`` is the global window index),
        fade-out where ``ends_before`` (the window ends strictly before the
        true end), zero for windows that are not ``live``."""
        dev = idx.device
        w = torch.ones((idx.shape[0], self.window), dtype=torch.float32,
                       device=dev)
        fade_in = torch.from_numpy(self._fade_in).to(dev)
        fade_out = torch.from_numpy(self._fade_out).to(dev)
        one = torch.ones((), device=dev)
        w[:, :self.overlap] = torch.where((idx > 0)[:, None],
                                          fade_in[None, :], one)
        w[:, self.window - self.overlap:] = torch.where(
            ends_before[:, None], fade_out[None, :], one)
        return w * live[:, None].to(torch.float32)

    @torch.inference_mode()
    def _enhance_whole_file(self, noisy: np.ndarray,
                            pcm16_out: bool) -> np.ndarray:
        """Whole-file device path: one upload, one download."""
        p = self.pipeline
        n = len(noisy)
        hop = self.window - self.overlap
        c = max(1, math.ceil(n / hop))      # the host path's window set
        total = (c - 1) * hop + self.window
        sig = np.zeros(total, noisy.dtype)
        sig[:n] = noisy
        sig = pcm_to_float(torch.from_numpy(sig).to(p.device))
        chunks = frame_signal(sig, self.window, hop)          # (c, W) view
        enh = torch.cat([p.enhance_tensor(chunks[i:i + self.chunk_batch])
                         for i in range(0, c, self.chunk_batch)])
        idx = torch.arange(c, device=p.device)
        w = self._window_weights(idx, idx * hop + self.window < n,
                                 torch.ones_like(idx, dtype=torch.bool))
        num = overlap_add(enh * w, hop, total)
        den = overlap_add(w, hop, total)
        out = (num / torch.clamp(den, min=1e-8))[:n]
        return (float_to_pcm(out) if pcm16_out else out).cpu().numpy()

    def _segment_ola(self, enh: torch.Tensor, idx0: int, n_rem: int,
                     pcm16_out: bool) -> torch.Tensor:
        """Cross-fade and overlap-add of one segment of already enhanced
        windows: (g, window) → the segment's weighted numerator,
        ``(g-1)·hop + window`` samples. ``idx0`` is the global index of the
        segment's first window, ``n_rem`` the true samples from its start.

        Linear ramps sum to exactly 1 where neighbouring windows overlap,
        so the global denominator is 1 almost everywhere and the host only
        adds the seams. The one exception is the file's tail when
        ``0 < n mod hop <= overlap``: the window before the last ends at or
        after n, so its fade-out is suppressed while the last window still
        fades in, and the summed weight over the last ``n mod hop`` samples
        is ``1 + fade_in``. That is divided out here, on the device and
        before any int16 quantization (the uncorrected numerator can reach
        twice full scale and would clip); division is linear, so segments
        that each correct their own share sum to the corrected total even
        when the tail's two windows lie in different segments."""
        dev = enh.device
        hop = self.window - self.overlap
        g = enh.shape[0]
        out_len = (g - 1) * hop + self.window
        li = torch.arange(g, device=dev)
        gi = idx0 + li
        w = self._window_weights(gi, li * hop + self.window < n_rem,
                                 (li * hop < n_rem) | (gi == 0))
        num = overlap_add(enh * w, hop, out_len)
        c_rem = (n_rem + hop - 1) // hop
        tail_start = (c_rem - 1) * hop
        tail_len = n_rem - tail_start            # n mod hop, with 0 → hop
        if 0 < tail_len <= self.overlap and idx0 + c_rem - 1 >= 1:
            lo, hi = max(tail_start, 0), min(tail_start + tail_len, out_len)
            if lo < hi:
                fade_in = torch.from_numpy(self._fade_in).to(dev)
                num[lo:hi] = num[lo:hi] / (
                    1.0 + fade_in[lo - tail_start:hi - tail_start])
        return float_to_pcm(num) if pcm16_out else num

    @torch.inference_mode()
    def _enhance_segmented(self, noisy: np.ndarray,
                           pcm16_out: bool) -> Optional[np.ndarray]:
        """Segmented device path; None when the input has too few segments
        to overlap anything (the caller then takes the whole-file path)."""
        p = self.pipeline
        dev = p.device
        n = len(noisy)
        hop = self.window - self.overlap
        gb = self.chunk_batch
        c = max(1, math.ceil(n / hop))
        n_seg = math.ceil(c / gb)
        if self.pipelined is not True and n_seg < 3:
            return None
        total = (c - 1) * hop + self.window
        sig = np.zeros(total, noisy.dtype)
        sig[:n] = noisy
        win_view = np.lib.stride_tricks.sliding_window_view(
            sig, self.window)[::hop]                       # (c, W), no copy
        cuda = dev.type == "cuda"
        if cuda:
            compute = torch.cuda.current_stream(dev)
            up, down = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
            on = torch.cuda.stream
        else:               # the same steps in order, with nothing to overlap
            up = down = None
            on = lambda stream: contextlib.nullcontext()  # noqa: E731
        wire = torch.int16 if sig.dtype == np.int16 else torch.float32

        def upload(s):
            """Stage segment s in a pinned buffer and start its copy."""
            rows = win_view[s * gb:(s + 1) * gb]
            staged = torch.empty(rows.shape, dtype=wire, pin_memory=cuda)
            staged.numpy()[...] = rows
            with on(up):
                x = staged.to(dev, non_blocking=True)
                ready = torch.cuda.Event() if cuda else None
                if cuda:
                    ready.record(up)
            return x, ready

        out = np.zeros(total, np.float32)

        def collect(s, host, done):
            """Add segment s, once its download has finished."""
            if done is not None:
                done.synchronize()
            part = host.numpy()
            if part.dtype == np.int16:
                part = part.astype(np.float32) * (1.0 / 32768.0)
            start = s * gb * hop
            out[start:start + len(part)] += part

        # the uploads run `transfer_depth` segments ahead of the compute and
        # the downloads trail it by as many: the segments staged on the host
        # and on the device stay bounded whatever the file's length
        uploads = collections.deque(
            upload(s) for s in range(min(self.transfer_depth, n_seg)))
        downloads = collections.deque()
        for s in range(n_seg):
            x, ready = uploads.popleft()
            if cuda:
                compute.wait_event(ready)
                x.record_stream(compute)
            y = self._segment_ola(p.enhance_tensor(x), s * gb,
                                  n - s * gb * hop, pcm16_out)
            if cuda:
                computed = torch.cuda.Event()
                computed.record(compute)
                down.wait_event(computed)
                y.record_stream(down)
            host = torch.empty(y.shape, dtype=y.dtype, pin_memory=cuda)
            with on(down):
                host.copy_(y, non_blocking=True)
                done = torch.cuda.Event() if cuda else None
                if cuda:
                    done.record(down)
            downloads.append((s, host, done))
            if s + self.transfer_depth < n_seg:
                uploads.append(upload(s + self.transfer_depth))
            while len(downloads) > self.transfer_depth:
                collect(*downloads.popleft())
        while downloads:
            collect(*downloads.popleft())
        out = out[:n]
        return self._quantize_host(out) if pcm16_out else out

    def _enhance_windows(self, chunks: np.ndarray) -> np.ndarray:
        """(C, window) noisy windows → (C, window) enhanced, in groups of
        ``chunk_batch`` when the pipeline has ``enhance_batch``."""
        batch_fn = getattr(self.pipeline, "enhance_batch", None)
        if batch_fn is None:
            return np.stack([self.pipeline.enhance_signal(c)
                             for c in chunks])
        return np.concatenate(
            [np.asarray(batch_fn(chunks[i:i + self.chunk_batch]))
             for i in range(0, len(chunks), self.chunk_batch)], axis=0)

    # ── public API ──────────────────────────────────────────────────────

    def enhance(self, noisy: np.ndarray,
                pcm16_out: bool = False) -> np.ndarray:
        """Enhance audio of any length with a constant device footprint.

        int16 input goes to the device as int16 (half the bytes of
        float32) and is converted there. ``pcm16_out=True`` returns int16
        PCM instead of float32; on the device paths the quantization
        happens on the device, so the result also comes back as int16.
        """
        noisy = np.asarray(noisy)
        wire = np.int16 if noisy.dtype == np.int16 else np.float32
        noisy = noisy.astype(wire)
        n = len(noisy)
        if n <= self.window:
            out = self.pipeline.enhance_signal(
                noisy.astype(np.float32) / 32768.0
                if wire == np.int16 else noisy)
            return self._quantize_host(out) if pcm16_out else out

        if self._has_device_path():
            if self.pipelined is not False:
                out = self._enhance_segmented(noisy, pcm16_out)
                if out is not None:
                    return out
            return self._enhance_whole_file(noisy, pcm16_out)

        hop = self.window - self.overlap
        starts = list(range(0, n, hop))
        chunks = np.zeros((len(starts), self.window), wire)
        for c, start in enumerate(starts):
            seg = noisy[start:start + self.window]
            chunks[c, :len(seg)] = seg
        enhanced = self._enhance_windows(chunks)

        out = np.zeros(n, np.float32)
        weight = np.zeros(n, np.float32)
        for c, start in enumerate(starts):
            end = min(start + self.window, n)
            e = enhanced[c, :end - start]
            w = np.ones(end - start, np.float32)
            if start > 0:
                w[:self.overlap] = self._fade_in[:min(self.overlap,
                                                      end - start)]
            if end < n:
                w[-self.overlap:] = self._fade_out[-min(self.overlap,
                                                        end - start):]
            out[start:end] += e * w
            weight[start:end] += w
        out = out / np.maximum(weight, 1e-8)
        return self._quantize_host(out) if pcm16_out else out

    @staticmethod
    def _quantize_host(wav: np.ndarray) -> np.ndarray:
        """int16 quantization on the host, the same function as
        ``utils.signal.float_to_pcm``, for the paths whose output arrived
        as float32."""
        scaled = np.clip(np.asarray(wav, np.float32) * 32768.0,
                         -32768.0, 32767.0)
        return np.round(scaled).astype(np.int16)

    def enhance_many(self, signals: Sequence[np.ndarray],
                     pad_quantum: int = 4000) -> List[np.ndarray]:
        """Enhance many utterances, batching groups of one padded length
        per forward pass.

        Utterances longer than ``window`` go through :meth:`enhance`; the
        rest are zero-padded up to their bucket's quantum and enhanced
        together, at most ``chunk_batch`` at a time. Output order matches
        the input's.
        """
        signals = [np.asarray(s, np.float32) for s in signals]
        results: List[Optional[np.ndarray]] = [None] * len(signals)

        buckets: dict[int, list[int]] = {}
        for idx, s in enumerate(signals):
            if len(s) > self.window:
                results[idx] = self.enhance(s)
            else:
                q = int(np.ceil(max(len(s), 1) / pad_quantum) * pad_quantum)
                buckets.setdefault(q, []).append(idx)

        batch_fn = getattr(self.pipeline, "enhance_batch", None)
        for q, idxs in sorted(buckets.items()):
            if batch_fn is None:
                for idx in idxs:
                    results[idx] = self.pipeline.enhance_signal(signals[idx])
                continue
            for i in range(0, len(idxs), self.chunk_batch):
                group = idxs[i:i + self.chunk_batch]
                padded = np.zeros((len(group), q), np.float32)
                for row, idx in enumerate(group):
                    padded[row, :len(signals[idx])] = signals[idx]
                out = np.asarray(batch_fn(padded))
                for row, idx in enumerate(group):
                    results[idx] = out[row, :len(signals[idx])]
        return results  # type: ignore[return-value]


def enhance_long(pipeline, noisy: np.ndarray, window: int = 32000,
                 overlap: int = 1600) -> np.ndarray:
    """One-shot long-form enhancement."""
    return StreamingEnhancer(pipeline, window, overlap).enhance(noisy)


class OnlineEnhancer:
    """Causal low-latency enhancement with a bounded algorithmic latency.

    Audio arrives in arbitrary pieces through :meth:`push`; enhanced audio
    streams out with a fixed, known delay.

    Contract: enhanced sample ``i`` is computed from input samples
    ``[max(0, i + lookahead - context), i + lookahead)`` only, a sliding
    window of ``context`` samples that sees at most ``lookahead`` samples of
    the future. The algorithmic latency (a sample's arrival to its enhanced
    value being emitted) is exactly ``lookahead + chunk`` samples
    (:attr:`latency_samples`): with the defaults 240 + 160 = 400 samples, 50
    ms at 8 kHz. The time of the forward pass comes on top.

    Every emitted ``chunk`` runs the pipeline's own batched enhancement on
    the current window, left-zero-padded at the stream's start, and takes
    the ``chunk`` samples that lie ``lookahead`` behind the window's
    trailing edge. The defaults satisfy:

      * ``chunk % hop == 0``: successive windows shift by whole frames;
      * ``lookahead >= n_fft - hop``: the emitted region's iSTFT overlap-add
        is complete inside the window;
      * the emitted region lies ``context - lookahead - chunk`` samples from
        the window's start, far from the attention's edge effects.

    The window is recomputed for every chunk instead of caching attention
    state: the window is the state (with the emit counter), and there is
    one implementation of every model.
    """

    def __init__(self, pipeline, context: int = 8000, chunk: int = 160,
                 lookahead: int = 240, hop: int = 80):
        if chunk % hop:
            raise ValueError("chunk must be a whole number of hops")
        if context % hop:
            raise ValueError("context must be a whole number of hops")
        if lookahead + chunk > context // 2:
            raise ValueError("context too small for the requested "
                             "lookahead + chunk")
        self.pipeline = pipeline
        self.context = context
        self.chunk = chunk
        self.lookahead = lookahead
        self._buf = np.zeros(0, np.float32)   # received, minus trimmed past
        self._trimmed = 0                     # samples dropped off the front
        self._emitted = 0                     # enhanced samples emitted
        self._received = 0

    @property
    def latency_samples(self) -> int:
        """Exact algorithmic latency: a sample arriving at position ``i``
        has been emitted by the time input position
        ``i + latency_samples`` arrives."""
        return self.lookahead + self.chunk

    def _window_for(self, end: int) -> np.ndarray:
        """The ``context`` samples ending at global position ``end``,
        left-zero-padded at the stream's start."""
        start = end - self.context
        w = np.zeros(self.context, np.float32)
        lo = max(start, self._trimmed)
        w[lo - start:] = self._buf[lo - self._trimmed:end - self._trimmed]
        return w

    def _enhance_window(self, window: np.ndarray) -> np.ndarray:
        batch_fn = getattr(self.pipeline, "enhance_batch", None)
        if batch_fn is not None:
            return np.asarray(batch_fn(window[None, :]))[0]
        return np.asarray(self.pipeline.enhance_signal(window))

    # -- per-stream bookkeeping, shared with OnlineEnhancerPool --------
    def _feed(self, samples: np.ndarray) -> None:
        """Buffer input without enhancing (the pool batches the compute)."""
        samples = np.asarray(samples, np.float32).ravel()
        self._buf = np.concatenate([self._buf, samples])
        self._received += len(samples)

    def _ready(self) -> bool:
        # a chunk [e, e+chunk) is final once input through e+chunk+lookahead
        # has arrived
        return self._emitted + self.chunk + self.lookahead <= self._received

    def _next_window(self) -> np.ndarray:
        """Window for the next finalizable chunk (caller checked _ready)."""
        return self._window_for(self._emitted + self.chunk + self.lookahead)

    def _accept(self, enh: np.ndarray) -> np.ndarray:
        """Take the enhanced window for the next chunk, advance the emit
        counter and drop the buffered past that can never be needed again;
        returns the finalized ``chunk`` samples."""
        out = enh[self.context - self.lookahead - self.chunk:
                  self.context - self.lookahead]
        self._emitted += self.chunk
        end = self._emitted + self.lookahead
        keep_from = max(self._trimmed, end - self.context)
        if keep_from > self._trimmed:
            self._buf = self._buf[keep_from - self._trimmed:]
            self._trimmed = keep_from
        return out

    def push(self, samples: np.ndarray) -> np.ndarray:
        """Feed audio of any length; returns whatever enhanced audio became
        final (possibly empty). The output, concatenated across calls, is
        sample-aligned with the input stream."""
        self._feed(samples)
        out = []
        while self._ready():
            out.append(self._accept(
                self._enhance_window(self._next_window())))
        return (np.concatenate(out) if out
                else np.zeros(0, np.float32))

    def flush(self) -> np.ndarray:
        """End of stream: zero-pad the future and emit the remaining
        ``received - emitted`` true samples."""
        remaining = self._received - self._emitted
        if remaining <= 0:
            return np.zeros(0, np.float32)
        k = (remaining + self.chunk - 1) // self.chunk
        npad = k * self.chunk + self.lookahead - remaining
        out = self.push(np.zeros(npad, np.float32))
        self._received -= npad             # the pad was not real input
        return out[:remaining]


class OnlineEnhancerPool:
    """Batched multi-stream online serving: ``n_streams`` concurrent
    :class:`OnlineEnhancer` streams advanced by one forward pass of shape
    ``(n_streams, context)`` per step.

    A single stream pays one forward pass per 20 ms chunk, which leaves the
    device almost idle; a server holds many concurrent calls, and stepping
    them together spreads the cost of a step over the whole pool.

    Each stream behaves exactly as a solo :class:`OnlineEnhancer`: the same
    sliding window and the same ``lookahead + chunk`` algorithmic latency.
    The batch is always ``(n_streams, context)``; rows of streams with no
    finalizable chunk are zeros and their output is discarded.

    :meth:`push` buffers a stream's input; :meth:`step` advances every
    stream that has a finalizable chunk (and does nothing when none has);
    :meth:`run` steps until drained; :meth:`take` collects a stream's
    finalized audio; :meth:`flush` ends a stream and returns everything of
    it not yet taken.
    """

    def __init__(self, pipeline, n_streams: int, context: int = 8000,
                 chunk: int = 160, lookahead: int = 240, hop: int = 80):
        if n_streams < 1:
            raise ValueError("n_streams must be >= 1")
        self.pipeline = pipeline
        self.streams = [
            OnlineEnhancer(pipeline, context=context, chunk=chunk,
                           lookahead=lookahead, hop=hop)
            for _ in range(n_streams)]
        self.n_streams = n_streams
        self.context = context
        self.chunk = chunk
        self.lookahead = lookahead
        self._out: list[list[np.ndarray]] = [[] for _ in range(n_streams)]

    @property
    def latency_samples(self) -> int:
        """Per-stream algorithmic latency, the solo mode's."""
        return self.streams[0].latency_samples

    def push(self, stream_id: int, samples: np.ndarray) -> None:
        """Buffer input for one stream (no device work: see step())."""
        self.streams[stream_id]._feed(samples)

    def step(self) -> int:
        """One batched forward pass advancing every ready stream by one
        chunk; returns how many streams advanced (0 = nothing was ready
        and no forward pass was made)."""
        ready = [i for i, s in enumerate(self.streams) if s._ready()]
        if not ready:
            return 0
        batch = np.zeros((self.n_streams, self.context), np.float32)
        for i in ready:
            batch[i] = self.streams[i]._next_window()
        enh = np.asarray(self.pipeline.enhance_batch(batch))
        for i in ready:
            self._out[i].append(self.streams[i]._accept(enh[i]))
        return len(ready)

    def run(self) -> int:
        """Step until no stream has a finalizable chunk; returns the
        number of batched forward passes made."""
        n = 0
        while self.step():
            n += 1
        return n

    def take(self, stream_id: int) -> np.ndarray:
        """Collect (and clear) a stream's finalized audio not yet
        delivered. Concatenated across take() and flush(), a stream's
        output is sample-aligned with its input, as in the solo mode."""
        chunks, self._out[stream_id] = self._out[stream_id], []
        return (np.concatenate(chunks) if chunks
                else np.zeros(0, np.float32))

    def flush(self, stream_id: int) -> np.ndarray:
        """End one stream: zero-pad its future, drain the pool and return
        everything of the stream not yet taken (other ready streams also
        advance during the drain; their chunks stay queued for their own
        take())."""
        s = self.streams[stream_id]
        head = self.take(stream_id)
        remaining = s._received - s._emitted
        if remaining <= 0:
            return head
        k = (remaining + self.chunk - 1) // self.chunk
        npad = k * self.chunk + self.lookahead - remaining
        s._feed(np.zeros(npad, np.float32))
        self.run()
        s._received -= npad                # the pad was not real input
        tail = self.take(stream_id)[:remaining]
        return np.concatenate([head, tail])
