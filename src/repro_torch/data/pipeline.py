"""Token data pipeline: deterministic synthetic streams and binary token
files, with a background prefetch thread (port of
``repro/data/pipeline.py``).

  * deterministic seeding by (seed, step): resuming from a checkpoint at
    step k regenerates exactly the batches k, k+1, ...; the batches are
    numpy arrays from ``np.random.default_rng((seed, step))``, bit-equal
    to the reference's;
  * placement: :func:`make_pipeline` copies each batch to ``device``
    (the CUDA device unless the caller says otherwise) from pinned host
    memory, on the prefetch thread, where the reference places it with
    the train step's shardings;
  * the prefetch thread keeps ``prefetch`` batches ahead of the step loop;
  * under a mesh every rank draws the global batch from (seed, step), as
    one process does, and keeps the shard its ``batch_specs`` name
    (``shard=``, e.g. ``launch.steps.shard_batch``), cut on the host
    before the copy to the device.

The file kind reads a local ``.bin`` of uint16 tokens.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..core.comm import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Data-source settings shared by the synthetic and file loaders."""
    kind: str = "synthetic"       # synthetic | file
    path: Optional[str] = None    # .bin of uint16 tokens (file kind)
    seed: int = 0
    vocab_size: int = 256
    batch: int = 8
    seq_len: int = 128
    # modality stubs
    frontend: Optional[str] = None
    d_model: int = 0
    vis_tokens: int = 0
    dec_ratio: int = 8


def _synthetic_tokens(cfg: DataConfig, step: int) -> np.ndarray:
    """Markov-ish synthetic tokens: a walk of steps in [-2, 2] from a
    random base, folded into a <= 512-token alphabet, so a small model's
    loss visibly falls."""
    rng = np.random.default_rng((cfg.seed, step))
    B, T = cfg.batch, cfg.seq_len
    alpha = min(cfg.vocab_size, 512)
    base = rng.integers(0, alpha, size=(B, 1))
    steps = rng.integers(-2, 3, size=(B, T)).cumsum(axis=1)
    toks = (base + np.abs(steps)) % alpha
    return toks.astype(np.int32)


def _file_tokens(cfg: DataConfig, step: int, arr: np.ndarray) -> np.ndarray:
    B, T = cfg.batch, cfg.seq_len
    n = arr.shape[0] - (T + 1)
    rng = np.random.default_rng((cfg.seed, step))
    starts = rng.integers(0, max(1, n), size=(B,))
    return np.stack([arr[s:s + T + 1] for s in starts]).astype(np.int32)


def make_batch(cfg: DataConfig, step: int, arr: Optional[np.ndarray] = None
               ) -> Dict[str, np.ndarray]:
    """One deterministic (tokens, labels) batch for ``step`` (numpy)."""
    if cfg.kind == "file":
        if arr is None:
            raise ValueError("the file kind needs the token array")
        chunk = _file_tokens(cfg, step, arr)     # [B, T+1]
        tokens, labels = chunk[:, :-1], chunk[:, 1:]
    else:
        tokens = _synthetic_tokens(cfg, step)
        labels = np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)
    batch: Dict[str, np.ndarray] = {"tokens": tokens, "labels": labels}
    if cfg.frontend == "vision_patches":
        rng = np.random.default_rng((cfg.seed, step, 7))
        batch["vision_embeds"] = rng.normal(
            size=(cfg.batch, cfg.vis_tokens, cfg.d_model)).astype(np.float32)
    elif cfg.frontend == "audio_frames":
        rng = np.random.default_rng((cfg.seed, step, 7))
        batch["frames"] = rng.normal(
            size=(cfg.batch, cfg.seq_len, cfg.d_model)).astype(np.float32)
        Td = max(1, cfg.seq_len // cfg.dec_ratio)
        batch["tokens"] = batch["tokens"][:, :Td]
        batch["labels"] = batch["labels"][:, :Td]
    return batch


def load_tokens(cfg: DataConfig) -> np.ndarray:
    """The file kind's token array: ``cfg.path`` as uint16, mod vocab."""
    raw = np.fromfile(cfg.path, dtype=np.uint16)
    return raw.astype(np.int32) % cfg.vocab_size


def synthetic_batches(cfg: DataConfig, start_step: int = 0
                      ) -> Iterator[Dict[str, np.ndarray]]:
    """Endless numpy batch iterator (file-backed when cfg.kind ==
    "file")."""
    arr = load_tokens(cfg) if cfg.kind == "file" else None
    step = start_step
    while True:
        yield make_batch(cfg, step, arr)
        step += 1


def _to_device(batch: Dict[str, np.ndarray], dev: torch.device
               ) -> Dict[str, torch.Tensor]:
    def move(v):
        t = torch.from_numpy(np.ascontiguousarray(v))
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        return t
    out = {}
    for k, v in batch.items():
        if hasattr(v, "shard"):         # a stored shard (launch/steps.py)
            v.shard = move(v.shard)
            out[k] = v
        else:
            out[k] = move(v)
    return out


def make_pipeline(cfg: DataConfig, device=None, start_step: int = 0,
                  prefetch: int = 2, shard: Optional[Callable] = None
                  ) -> Iterator[Dict[str, torch.Tensor]]:
    """Device-placed, background-prefetched batch stream (tensors on
    ``device``, the CUDA device unless the caller says otherwise); with
    ``shard``, each numpy batch is replaced by ``shard(batch)`` (a rank's
    shard of it) before the copy.  The thread starts at the first batch
    and stops when the generator is closed or collected."""
    dev = resolve_device(device)
    src = synthetic_batches(cfg, start_step)
    if shard is not None:
        src = map(shard, src)
    return _prefetched(src, dev, prefetch)


def _prefetched(src, dev: torch.device, prefetch: int):
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        try:
            for b in src:
                item = _to_device(b, dev)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except Exception as e:  # surfaced to the consumer
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
