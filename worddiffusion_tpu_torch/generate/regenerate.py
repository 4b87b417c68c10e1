"""OCR-filtered dataset regeneration, the main inference pipeline (port
of ``worddiffusion_tpu/generate/regenerate.py``).

- Resumable: the output directory (and any prior dump folders) is
  scanned once, and (image, writer, word) crops already there are
  skipped.
- Static batches: the last batch is padded to ``batch_size`` by
  repeating its own items; only the real ones are kept.
- Writer-id perturbation (``sid_change``) offsets every writer id.
- A ``use_phosc`` model gets each batch's PHOSC ids.
- Pipelined dispatch: up to ``queue_depth`` batches are queued on the
  device before the host drains the oldest one (OCR decode, accept
  filter, PNG writes). ``_drain`` is the only place that waits for the
  device.
- Accept filter: the greedy CTC decode of a generated image must equal
  its conditioning word exactly.
- Cooperative stop through a stop-flag file.
"""

from __future__ import annotations

import glob
import logging
import os
from collections import deque
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..data.alphabets import OCR_ENG
from ..data.gt import Sample
from ..ops.ctc import collapse_and_decode
from ..utils.images import regen_filename, save_single_images
from ..utils.stop_flag import StopFlag
from .sample import WordSampler, phosc_ids

log = logging.getLogger("worddiffusion")


@dataclass
class RegenStats:
    generated: int = 0
    accepted: int = 0
    skipped_existing: int = 0

    @property
    def accept_rate(self) -> float:
        return self.accepted / max(self.generated, 1)


def scan_existing(out_dir: str) -> set:
    if not os.path.isdir(out_dir):
        return set()
    return set(os.listdir(out_dir))


def scan_history(out_dir: str, prior_dirs: Sequence[str] = ()) -> set:
    """Already-generated crop filenames across the output directory and
    previous dump folders (entries may be globs; missing paths are
    ignored)."""
    existing = scan_existing(out_dir)
    for pattern in prior_dirs:
        for d in glob.glob(pattern) or [pattern]:
            existing |= scan_existing(d)
    return existing


class Regenerator:
    def __init__(
        self,
        sampler: WordSampler,
        ocr_alphabet: str = OCR_ENG,
        out_dir: str = "./regen",
        writer_lookup=None,              # raw writer str -> dense id
        sid_change: int = 0,
        stop_flag: Optional[str] = None,
        keep_rejected: bool = False,
        prior_dirs: Sequence[str] = (),
        queue_depth: int = 2,
    ):
        """The accept filter needs a sampler built with ``ocr_apply``;
        without one every generated image is kept."""
        self.sampler = sampler
        self.ocr_alphabet = ocr_alphabet
        self.out_dir = out_dir
        self.writer_lookup = writer_lookup or (lambda w: int(w) if str(w).isdigit() else 0)
        self.sid_change = sid_change
        self.stop = StopFlag(stop_flag)
        self.keep_rejected = keep_rejected
        self.prior_dirs = tuple(prior_dirs)
        self.queue_depth = max(1, queue_depth)

    def run(
        self,
        samples: Sequence[Sample],
        batch_size: int = 64,
        seed: int = 0,
        max_batches: Optional[int] = None,
    ) -> RegenStats:
        os.makedirs(self.out_dir, exist_ok=True)
        existing = scan_history(self.out_dir, self.prior_dirs)
        stats = RegenStats()
        todo = []
        for s in samples:
            name = regen_filename(s.image, s.writer, s.word)
            if name in existing:
                stats.skipped_existing += 1
            else:
                todo.append((s, name))
        log.info(
            "regen: %d to generate, %d already present", len(todo), stats.skipped_existing
        )
        generator = torch.Generator(device=self.sampler.device).manual_seed(seed)

        pending = deque()  # (device outputs, chunk, n_real)
        for bi, start in enumerate(range(0, len(todo), batch_size)):
            if max_batches is not None and bi >= max_batches:
                break
            if self.stop.should_stop():
                log.info("stop flag raised; ending regen")
                break
            chunk = todo[start : start + batch_size]
            n_real = len(chunk)
            while len(chunk) < batch_size:  # pad to a static batch
                chunk = chunk + chunk[: batch_size - len(chunk)]
            words = [s.word for s, _ in chunk]
            wids = np.asarray([self.writer_lookup(s.writer) for s, _ in chunk], np.int64)
            if self.sid_change:
                wids = wids + self.sid_change
            phosc = None
            if self.sampler.exp.unet.use_phosc:
                phosc = phosc_ids(words, self.sampler.exp.data.phos_version)
            out = self.sampler.sample_async(words, wids, generator, phosc)
            pending.append((out, chunk, n_real))
            if len(pending) > self.queue_depth:
                self._drain(pending.popleft(), stats)
            if (bi + 1) % 10 == 0:
                log.info(
                    "regen batch %d: accept-rate %.3f (%d/%d)",
                    bi, stats.accept_rate, stats.accepted, stats.generated,
                )
        while pending:
            self._drain(pending.popleft(), stats)
        log.info(
            "regen done: %d generated, %d accepted (%.3f), %d pre-existing",
            stats.generated, stats.accepted, stats.accept_rate, stats.skipped_existing,
        )
        return stats

    def _drain(self, pending, stats: RegenStats) -> None:
        """Wait for one queued batch and post-process it on the host."""
        out, chunk, n = pending
        if isinstance(out, tuple):  # fused OCR: (uint8 images, frame ids)
            images, ids = (o.cpu().numpy()[:n] for o in out)
            self._process(images, chunk[:n], stats, frame_ids=ids)
        else:
            self._process(out.cpu().numpy()[:n], chunk[:n], stats)

    def _process(self, images: np.ndarray, chunk, stats: RegenStats, frame_ids=None) -> None:
        stats.generated += len(chunk)
        if frame_ids is not None:
            decoded = collapse_and_decode(frame_ids, self.ocr_alphabet)
            keep = [i for i, ((s, _), d) in enumerate(zip(chunk, decoded)) if d == s.word]
        else:
            keep = list(range(len(chunk)))
        stats.accepted += len(keep)
        if keep:
            save_single_images(images[keep], [chunk[i][1] for i in keep], self.out_dir)
        if self.keep_rejected:
            kept = set(keep)
            rej = [i for i in range(len(chunk)) if i not in kept]
            if rej:
                save_single_images(
                    images[rej], [chunk[i][1] for i in rej],
                    os.path.join(self.out_dir, "rejected"),
                )
