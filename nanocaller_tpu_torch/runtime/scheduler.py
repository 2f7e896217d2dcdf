"""Chunk scheduler of the port: host feature workers feeding the device
owner, the chunk-level run manifest for idempotent restart (--resume;
the reference has no job-level resume, SURVEY.md §5.4) and the progress
reporter.

N feature processes (io, pileup, phase and the host alignment helpers;
never torch) stream their results to the main process, which alone
holds the device and runs the kernels and the CNNs as results arrive.
Results come back in completion order and are stored by chunk index,
so the VCF shards stay deterministic.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import sys

from . import watchdog


def worker_pool(n_workers, init_args):
    """A ProcessPoolExecutor of feature workers started with `spawn`, so
    that no worker inherits the main process's CUDA context. The native
    host library is built here first, so the workers only load it."""
    from concurrent.futures import ProcessPoolExecutor

    from ..io.native import get_lib
    from . import workers

    get_lib()
    return ProcessPoolExecutor(
        max_workers=n_workers, mp_context=mp.get_context("spawn"),
        initializer=workers.init_worker, initargs=init_args)


def feature_stream(chunks, worker_fn, init_args, n_workers):
    """Yield worker_fn((idx, chunk)) for every chunk.

    n_workers <= 1 (or a single chunk) runs inline, in this process.

    A crashed or killed worker surfaces as BrokenProcessPool: the
    unfinished chunks are requeued ONCE in a fresh pool, and a second
    death raises a RuntimeError that names --resume (the run manifest
    still points at every completed shard) instead of hanging.
    """
    from . import workers

    tasks = list(enumerate(chunks))
    if n_workers <= 1 or len(tasks) <= 1:
        workers.init_worker(*init_args)
        try:
            for task in tasks:
                yield worker_fn(task)
        finally:
            workers._G.clear()
        return
    yield from _pool_stream(tasks, worker_fn, init_args, n_workers)


def _pool_stream(tasks, worker_fn, init_args, n_workers):
    from concurrent.futures import as_completed
    from concurrent.futures.process import BrokenProcessPool

    remaining = list(tasks)
    for attempt in (1, 2):
        delivered = set()
        try:
            ex = worker_pool(min(n_workers, len(remaining)), init_args)
            try:
                futs = [(ex.submit(worker_fn, t), t) for t in remaining]
                for f, t in _completed_pairs(futs, as_completed):
                    result = f.result()  # raises BrokenProcessPool on death
                    delivered.add(t[0])
                    yield result
            finally:
                # consumer errors, Ctrl-C or closing the generator must not
                # wait out the whole queued feature backlog
                ex.shutdown(wait=True, cancel_futures=True)
            return
        except BrokenProcessPool:
            remaining = [t for t in remaining if t[0] not in delivered]
            if attempt == 2 or not remaining:
                raise RuntimeError(
                    "feature worker died (killed/OOM?); %d chunk(s) "
                    "unfinished after retry — completed chunks are in the "
                    "run manifest, rerun with --resume" % len(remaining))
            print("warning: feature worker died; requeueing %d chunk(s) "
                  "in a fresh pool" % len(remaining), file=sys.stderr)


def _completed_pairs(futs, as_completed):
    by_fut = dict(futs)
    for f in as_completed(by_fut):
        yield f, by_fut[f]


class RunManifest:
    """Tracks completed chunks; a restart skips finished work and reuses
    the per-chunk shard files."""

    def __init__(self, path, shard_dir=None):
        self.path = path
        self.shard_dir = shard_dir or os.path.join(
            os.path.dirname(path), "intermediate_shards")
        os.makedirs(self.shard_dir, exist_ok=True)
        self.done = {}
        if os.path.exists(path):
            try:
                with open(path) as fh:
                    self.done = json.load(fh)
            except (ValueError, OSError):
                self.done = {}
        # drop entries whose shard files vanished
        self.done = {k: v for k, v in self.done.items() if os.path.exists(v)}

    @staticmethod
    def chunk_key(stage, chunk):
        return "%s:%s:%d-%d" % (stage, chunk["chrom"], chunk["start"],
                                chunk["end"])

    def is_done(self, stage, chunk):
        return self.chunk_key(stage, chunk) in self.done

    def shard_path(self, stage, chunk):
        return self.done.get(self.chunk_key(stage, chunk))

    def mark_done(self, stage, chunk, shard_path):
        self.done[self.chunk_key(stage, chunk)] = shard_path
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self.done, fh)
        os.replace(tmp, self.path)
        # a finished chunk is progress for a supervising --watchdog
        watchdog.beat()


class Progress:
    """Minimal progress reporter (tqdm when available and a TTY)."""

    def __init__(self, total, desc, suppress=False):
        self.n = 0
        self.total = total
        self.desc = desc
        self.suppress = suppress
        self._bar = None
        if not suppress:
            try:
                from tqdm import tqdm

                self._bar = tqdm(total=total, desc=desc)
            except ImportError:
                pass

    def update(self, k=1):
        self.n += k
        if self._bar is not None:
            self._bar.update(k)
        watchdog.beat()

    def close(self):
        if self._bar is not None:
            self._bar.close()
