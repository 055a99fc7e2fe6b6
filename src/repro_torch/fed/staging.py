"""Batch staging (counterpart of ``repro/fed/staging.py``).

``client_batch_fn(cid, rng)`` yields one local minibatch of host (numpy)
arrays; a cohort's K per-step batches for S clients stack on the host to
leading (S, K, ...) axes and cross to the device once per leaf.  Draws
happen client by client, K each, from the shared generator — the
reference's order.  The async runtime stages one client a dispatch
(``stage_client_batches``) with a leading axis of 1, so its local update
runs the same stacked path at S=1.

``StagingBuffers`` are the chunk pipeline's (``fed.pipeline``) reusable
(S, K, ...) host buffers, refilled row by row from background stager
threads.  For a CUDA run they are pinned host tensors, so the copy to the
card is asynchronous (``non_blocking=True``); a buffer whose copy may
still be in flight is not handed out for refilling until the event
recorded after that copy has completed.

Thread-safety contract
----------------------

Under the background stager a ``client_batch_fn`` may be called from
worker threads, concurrently for different clients.  A fn is safe to call
concurrently iff it is a pure function of ``(cid, rng)`` (the rng passed
in is private to the client).  Mark such fns with ``mark_thread_safe``;
the built-in scenario batch fns are marked.  Unmarked fns are serialized
through a module lock: always correct, without intra-chunk parallelism.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.utils.tree import tree_leaves, tree_map

_UNSAFE_FN_LOCK = threading.Lock()


def mark_thread_safe(fn):
    """Declare ``fn`` safe for concurrent calls (a pure function of its
    arguments).  Returns ``fn`` so it works as a decorator."""
    fn._repro_thread_safe = True
    return fn


def is_thread_safe(fn) -> bool:
    return bool(getattr(fn, "_repro_thread_safe", False))


def serialized_unless_thread_safe(fn):
    """Call-through wrapper enforcing the staging contract: unmarked fns
    run under a module-wide lock."""
    if is_thread_safe(fn):
        return fn

    def locked(*a, **kw):
        with _UNSAFE_FN_LOCK:
            return fn(*a, **kw)
    return locked


def _stacker(tree):
    """np.stack when every leaf is host-side, else torch.stack."""
    on_host = all(isinstance(leaf, np.ndarray) or np.isscalar(leaf)
                  for leaf in tree_leaves(tree))
    return np.stack if on_host else torch.stack


def _stack_steps(client_batch_fn, cid: int, local_steps: int, rng):
    """One client's K per-step batches stacked to a (K, ...) tree."""
    steps = [client_batch_fn(int(cid), rng) for _ in range(local_steps)]
    stack = _stacker(steps[0])
    return tree_map(lambda *xs: stack(xs), *steps)


def _to_device(x, device):
    return (torch.from_numpy(np.asarray(x)) if not isinstance(x, torch.Tensor)
            else x).to(device)


def stack_clients(per_client, device):
    """(K, ...) client trees stacked to (S, K, ...) device tensors."""
    stack = _stacker(per_client[0])
    stacked = tree_map(lambda *xs: stack(xs), *per_client)
    return tree_map(lambda x: _to_device(x, device), stacked)


def stage_cohort_batches(client_batch_fn, cohort, local_steps: int, rng,
                         device):
    """A cohort's batches as device tensors with leading (S, K, ...) axes."""
    return stack_clients([_stack_steps(client_batch_fn, cid, local_steps,
                                       rng) for cid in cohort], device)


def stage_client_batches(client_batch_fn, cid: int, local_steps: int, rng,
                         device):
    """One client's K batches as device tensors with leading (1, K, ...)
    axes, drawn as the reference's ``stage_client_batches`` draws them."""
    return stage_cohort_batches(client_batch_fn, [cid], local_steps, rng,
                                device)


# ---------------------------------------------------------- host buffers

class StagingBuffers:
    """Preallocated, reusable (S, K, ...) host buffers for batch staging.

    One buffer tree per ``(key, s)``, allocated from the first staged
    client's leaf shapes and dtypes and refilled in place afterwards; rows
    are written independently (``fill_row``), so disjoint clients can be
    filled from concurrent stager threads.  ``pin=True`` (a CUDA run)
    pins them.  ``to_device`` copies a tree to the device: from pinned
    buffers, asynchronously on ``stream`` and followed by an event, which
    ``get`` waits on before handing the tree out for refilling.
    """

    def __init__(self, pin: bool = False):
        self.pin = bool(pin)
        self._bufs: dict = {}
        self._copies: dict = {}        # (key, s) -> event after its copy
        # concurrent stager workers race on lazy allocation
        self._lock = threading.Lock()

    def get(self, key, s: int, template):
        """The (S, ...) buffer tree for ``(key, s)``, free to refill;
        ``template`` is one client's stacked (K, ...) tree."""
        with self._lock:
            buf = self._bufs.get((key, s))
            if buf is None:
                buf = tree_map(
                    lambda x: torch.empty(
                        (s, *np.shape(x)), dtype=torch.from_numpy(
                            np.empty(0, np.asarray(x).dtype)).dtype,
                        pin_memory=self.pin), template)
                self._bufs[(key, s)] = buf
            event = self._copies.get((key, s))
        if event is not None:
            event.synchronize()        # its last copy to the card is done
        return buf

    def peek(self, key, s: int):
        """The already-allocated buffer tree for ``(key, s)`` (KeyError if
        no client was staged into it yet)."""
        with self._lock:
            return self._bufs[(key, s)]

    @staticmethod
    def fill_row(buf, i: int, row):
        """Write one client's (K, ...) tree into row ``i`` in place."""
        tree_map(lambda b, r: b[i].copy_(torch.from_numpy(np.asarray(r))),
                 buf, row)

    def to_device(self, key, s: int, device, stream=None):
        """The tree of ``(key, s)`` on ``device``: a copy the buffer no
        longer backs.  On CUDA the copy is enqueued on ``stream`` (default:
        the current one) without waiting, and ``get`` holds back the next
        refill until it has completed."""
        buf = self.peek(key, s)
        device = torch.device(device)
        if device.type != "cuda":
            return tree_map(lambda b: b.clone(), buf)
        stream = stream or torch.cuda.current_stream(device)
        with torch.cuda.stream(stream):
            out = tree_map(lambda b: b.to(device, non_blocking=self.pin),
                           buf)
            event = torch.cuda.Event()
            event.record(stream)
        with self._lock:
            self._copies[(key, s)] = event
        return out
