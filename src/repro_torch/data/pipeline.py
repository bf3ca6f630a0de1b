"""Training data pipeline + straggler monitoring.

``TokenPipeline`` produces deterministic synthetic token streams (seeded by
(step, shard) exactly as the reference's, so the port's batches equal the
reference's bit for bit and a restart resumes bit-identically), packs them
into fixed (batch, seq) blocks, and prefetches on a background thread so
host data work overlaps the device step.  ``close()`` stops and joins the
thread; an error in the thread is raised by the next ``next()``.

``StragglerMonitor`` tracks a step-time EWMA and flags outliers.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

_POLL_S = 0.2                      # the producer and consumer re-check stop and errors
_JOIN_S = 10.0                     # close() gives the producer this long to stop


def synth_batch(vocab: int, batch: int, seq: int, step: int, shard: int = 0, d_model=None,
                mode="tokens"):
    rng = np.random.default_rng((step * 9_973 + shard) % (2**63))
    if mode == "embeddings":
        return {
            "embeds": rng.standard_normal((batch, seq, d_model)).astype(np.float32),
            "labels": rng.integers(0, vocab, (batch, seq)).astype(np.int32),
        }
    return {
        "tokens": rng.integers(0, vocab, (batch, seq)).astype(np.int32),
        "labels": rng.integers(0, vocab, (batch, seq)).astype(np.int32),
    }


class TokenPipeline:
    def __init__(self, vocab: int, batch: int, seq: int, mode="tokens", d_model=None,
                 n_vision_tokens: int = 0, prefetch: int = 2, start_step: int = 0):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.mode, self.d_model = mode, d_model
        self.n_vision = n_vision_tokens
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._step = start_step
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self._t = threading.Thread(target=self._produce, daemon=True)
        self._t.start()

    def _make(self, step: int):
        b = synth_batch(self.vocab, self.batch, self.seq, step,
                        d_model=self.d_model, mode=self.mode)
        if self.mode == "tokens+vision":
            rng = np.random.default_rng(step + 17)
            b["vision"] = rng.standard_normal(
                (self.batch, self.n_vision, self.d_model)
            ).astype(np.float32)
        return b

    def _produce(self):
        try:
            while not self._stop.is_set():
                item = self._make(self._step)
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=_POLL_S)
                        break
                    except queue.Full:
                        continue
                self._step += 1
        except Exception as e:  # noqa: BLE001 — handed to the consumer
            self._error = e

    def __next__(self):
        while True:
            try:
                return self._q.get(timeout=_POLL_S)
            except queue.Empty:
                if self._error is not None:
                    raise RuntimeError("the data pipeline's producer failed") from self._error
                if not self._t.is_alive():
                    raise StopIteration

    def __iter__(self):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        """Stop the producer and join it; raises if it does not stop."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._t.join(timeout=_JOIN_S)
        if self._t.is_alive():
            raise RuntimeError("the data pipeline's producer did not stop")


class StragglerMonitor:
    def __init__(self, alpha: float = 0.1, threshold: float = 2.0, warmup: int = 3):
        self.alpha, self.threshold, self.warmup = alpha, threshold, warmup
        self.ewma = None
        self.count = 0
        self.flagged: list[tuple[int, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        self.count += 1
        if self.ewma is None:
            self.ewma = dt
            return False
        is_slow = self.count > self.warmup and dt > self.threshold * self.ewma
        if is_slow:
            self.flagged.append((step, dt))
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_slow
