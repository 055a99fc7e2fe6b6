"""Sparse client-state store: the ``ClientStateSpec`` protocol, lazily —
counterpart of ``repro/fed/population/state.py``.

Per-client state is stacked with a leading axis on the run's device.  At
population scale that axis cannot be the population, so the store sizes
it to a fixed ``budget`` of *slots* and keeps the client-id -> slot map on
the host:

* a client's state materializes on first selection (the spec's zero-init
  row),
* hot clients stay resident (LRU on every selection),
* cold rows spill to ``.npz`` files through the checkpoint store
  (``save_pytree``/``load_pytree``: exact dtypes, bf16 as raw bits) and
  are restored bit for bit when the client is drawn again.

``acquire(cohort_ids)`` returns the cohort's slot indices, by which the
round gathers and scatters (the grafts write the stacked state in place,
as the port's state protocol does).  ``server_update`` still receives
``n_clients = population_size``; shared globals (SCAFFOLD's ``c_global``)
stay resident, and only private rows (``state_export``/``state_import``)
travel to disk.

The chunk pipeline (``fed.pipeline``) uses the streaming forms:
``acquire(ids, defer_restore=True)`` assigns slots but leaves the missing
rows pending for ``collect_pending``, chunk by chunk (one host buffer per
chunk, pinned on a CUDA run, fresh rows broadcast-filled).  Evictions of
one acquire leave as one batched export and one group ``.npz`` written
behind the round by the store's I/O threads (``enable_async_io``);
``prefetch`` loads upcoming chunks' archives on the same threads; a row
whose group save is still in flight restores from the in-memory export.

On a CUDA run a group export crosses to the host without stalling the
card's queue: an event is recorded on the compute stream after the
export, a stream of the store's own waits on it and copies the rows into
pinned host memory, and the writer thread waits on that copy's event.
"""
from __future__ import annotations

import os
import tempfile
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.store import load_pytree, save_pytree
from repro_torch.core.algorithms import (
    ClientStateSpec, state_export, state_import, state_import_many,
)
from repro_torch.utils.tree import tree_leaves, tree_map


def _device_of(tree):
    return tree_leaves(tree)[0].device


def _host_like(tree, lead=(), pin=False):
    """Empty host tensors shaped ``lead + leaf.shape`` like ``tree``."""
    return tree_map(lambda f: torch.empty((*lead, *f.shape), dtype=f.dtype,
                                          pin_memory=pin), tree)


class DenseClientStore:
    """Budget covers the whole population: slots are client ids, no
    spilling — the golden reference the sparse store is tested bitwise
    against."""

    def __init__(self, proto: ClientStateSpec, params, population_size: int):
        self.proto = proto
        self.budget = int(population_size)
        self.population_size = int(population_size)
        self.state = proto.init(params, population_size)
        # zero-init row: what evict_client resets a departed row to
        self._fresh = state_export(proto, proto.init(params, 1), 0)
        self.spills = 0
        self.restores = 0
        self._touched: set = set()

    @property
    def resident(self) -> int:
        return len(self._touched)

    @property
    def peak_resident(self) -> int:
        return len(self._touched)

    def acquire(self, ids, defer_restore: bool = False) -> np.ndarray:
        del defer_restore      # every row is always resident
        ids = np.asarray(ids, np.int64)
        self._touched.update(int(c) for c in ids)
        return ids

    # streaming no-ops: the dense store has nothing to restore or spill
    def enable_async_io(self, workers: int = 2):
        return self

    def prefetch(self, ids) -> None:
        pass

    def collect_pending(self, ids):
        return None

    def flush_io(self) -> None:
        pass

    def evict_client(self, cid: int) -> bool:
        """Churn departure: reset ``cid``'s row to the spec's zero-init."""
        cid = int(cid)
        if cid not in self._touched:
            return False
        self._touched.discard(cid)
        self.state = state_import(self.proto, self.state, cid, self._fresh)
        return True


class _Done:
    """Resolved-future stand-in for the synchronous (no-worker) I/O path."""

    def __init__(self, value=None):
        self._value = value

    def result(self):
        return self._value


class ClientStateStore:
    """LRU-budgeted sparse store over a ``budget``-slot stacked state."""

    def __init__(self, proto: ClientStateSpec, params, population_size: int,
                 budget: int, spill_dir: Optional[str] = None):
        if budget < 1:
            raise ValueError(f"state budget must be >= 1, got {budget}")
        if budget > population_size:
            raise ValueError(
                f"state budget {budget} exceeds population {population_size}"
                " (use DenseClientStore / make_client_store)")
        self.proto = proto
        self.budget = int(budget)
        self.population_size = int(population_size)
        self.state = proto.init(params, budget)
        # the zero-init row: graft source for first-time clients and the
        # load_pytree template for restores
        self._fresh = state_export(proto, proto.init(params, 1), 0)
        self.device = _device_of(self._fresh)
        self._cuda = self.device.type == "cuda"
        if spill_dir is None:
            spill_dir = tempfile.mkdtemp(prefix="repro_client_spill_")
        self.spill_dir = spill_dir
        os.makedirs(self.spill_dir, exist_ok=True)
        self._slot_of: "OrderedDict[int, int]" = OrderedDict()  # LRU order
        self._free = list(range(budget - 1, -1, -1))
        self._spilled: set = set()          # per-client .npz (eager path)
        self.spills = 0
        self.restores = 0
        self.peak_resident = 0
        # ---- streaming state (deferred acquire / write-behind groups)
        self._io = None                     # ThreadPoolExecutor when enabled
        self._io_stream = None              # CUDA: device-to-host copies
        self._io_lock = threading.Lock()
        self._pending: "OrderedDict[int, int]" = OrderedDict()  # cid -> slot
        self._group_of: dict = {}           # cid -> (path, row index)
        self._group_live: dict = {}         # path -> set of unrestored cids
        self._group_rows: dict = {}         # path -> row count
        self._inflight: dict = {}           # cid -> (path, host rows, idx,
        #                                     copy event)
        self._save_futs: dict = {}          # path -> save future
        self._archive_futs: dict = {}       # path -> prefetch-load future
        self._archive_cache: dict = {}      # path -> host row-stack tree
        self._row_futs: dict = {}           # cid -> per-client load future
        self._cleanup_futs: list = []
        self._group_seq = 0
        self._fresh_host = None             # lazy host copy of self._fresh

    # ------------------------------------------------------------- plumbing

    @property
    def resident(self) -> int:
        return len(self._slot_of)

    def _spill_path(self, cid: int) -> str:
        return os.path.join(self.spill_dir, f"client_{cid:012d}.npz")

    def _evict_one(self, protected: set) -> int:
        """Spill the least-recently-used client not in the incoming cohort;
        returns its freed slot."""
        for cid in self._slot_of:          # OrderedDict: LRU first
            if cid not in protected:
                slot = self._slot_of.pop(cid)
                save_pytree(state_export(self.proto, self.state, slot),
                            self._spill_path(cid))
                self._spilled.add(cid)
                self.spills += 1
                return slot
        raise RuntimeError(
            f"cannot evict: all {self.budget} resident clients are in the "
            "incoming cohort (state budget must be >= cohort size)")

    def _on_device(self, row):
        return tree_map(lambda r, f: torch.as_tensor(r).to(f.device),
                        row, self._fresh)

    # -------------------------------------------------------------- acquire

    def acquire(self, ids, defer_restore: bool = False) -> np.ndarray:
        """Slot indices for a cohort of global client ids, materializing or
        restoring rows as needed.

        ``defer_restore=True`` (the chunk pipeline) assigns slots without
        touching ``self.state``: missing rows pend until the caller drains
        them chunk-wise with ``collect_pending`` and grafts them itself;
        evictions batch into one write-behind group spill."""
        ids = np.asarray(ids, np.int64)
        if len(ids) > self.budget:
            raise ValueError(
                f"cohort of {len(ids)} exceeds the state budget "
                f"{self.budget}: every cohort member needs a resident slot")
        incoming = {int(c) for c in ids}
        if len(incoming) != len(ids):
            raise ValueError("acquire wants distinct client ids")
        if defer_restore:
            return self._acquire_deferred(ids, incoming)
        slots = np.empty(len(ids), np.int64)
        # collect every missing client's (slot, row), then graft them in
        # one batched scatter; evictions during collection only export
        # previous residents, whose rows are untouched until the scatter
        miss_slots, miss_rows = [], []
        for i, cid in enumerate(int(c) for c in ids):
            if cid in self._slot_of:
                self._slot_of.move_to_end(cid)      # touch
                slots[i] = self._slot_of[cid]
                continue
            slot = self._free.pop() if self._free else \
                self._evict_one(incoming)
            if cid in self._spilled:
                row = load_pytree(self._fresh, self._spill_path(cid))
                self._spilled.discard(cid)
                os.unlink(self._spill_path(cid))
                self.restores += 1
            elif cid in self._group_of:
                # spilled by a pipelined round's group file
                row = self._on_device(self._row_from_group(cid))
                self.restores += 1
            else:
                row = self._fresh               # first selection: zero-init
            miss_slots.append(slot)
            miss_rows.append(row)
            self._slot_of[cid] = slot
            slots[i] = slot
        if miss_slots:
            stacked = tree_map(lambda *xs: torch.stack(xs), *miss_rows)
            self.state = state_import_many(
                self.proto, self.state,
                torch.as_tensor(np.asarray(miss_slots, np.int64)), stacked)
        self.peak_resident = max(self.peak_resident, len(self._slot_of))
        return slots

    # ----------------------------------------------- streaming: deferred

    def enable_async_io(self, workers: int = 2):
        """Run spill writes and restore reads on background threads.
        Without this every streaming I/O hook runs synchronously."""
        if self._io is None and workers > 0:
            from concurrent.futures import ThreadPoolExecutor
            self._io = ThreadPoolExecutor(
                max_workers=int(workers),
                thread_name_prefix="repro-state-io")
        return self

    def _submit(self, fn, *args):
        if self._io is None:
            return _Done(fn(*args))
        return self._io.submit(fn, *args)

    def _acquire_deferred(self, ids, incoming) -> np.ndarray:
        if self._pending:
            raise RuntimeError(
                "acquire(defer_restore=True) with rows still pending — "
                "drain the previous cohort with collect_pending first")
        slots = np.empty(len(ids), np.int64)
        missing = []                        # (position, cid)
        for i, cid in enumerate(int(c) for c in ids):
            if cid in self._slot_of:
                self._slot_of.move_to_end(cid)      # touch
                slots[i] = self._slot_of[cid]
            else:
                missing.append((i, cid))
        evicted = []                        # (cid, slot) this acquire spills
        for i, cid in missing:
            if self._free:
                slot = self._free.pop()
            else:
                vcid, slot = self._evict_candidate(incoming)
                evicted.append((vcid, slot))
            self._slot_of[cid] = slot
            self._pending[cid] = slot
            slots[i] = slot
        if evicted:
            self._spill_group(evicted)
        self.peak_resident = max(self.peak_resident, len(self._slot_of))
        return slots

    def _evict_candidate(self, protected: set):
        """Pop the LRU resident not in the incoming cohort (the caller
        batches the group spill)."""
        for cid in self._slot_of:
            if cid not in protected:
                return cid, self._slot_of.pop(cid)
        raise RuntimeError(
            f"cannot evict: all {self.budget} resident clients are in the "
            "incoming cohort (state budget must be >= cohort size)")

    def _export_to_host(self, slots):
        """One batched gather of ``slots``' rows, on its way to the host:
        (host rows, event after their copy or None)."""
        idx = torch.as_tensor(slots, dtype=torch.long)
        if not self._cuda:
            return state_export(self.proto, self.state, idx), None
        rows = state_export(self.proto, self.state, idx.to(self.device))
        exported = torch.cuda.Event()
        exported.record(torch.cuda.current_stream(self.device))
        if self._io_stream is None:
            self._io_stream = torch.cuda.Stream(self.device)
        host = _host_like(tree_map(lambda r: r[0], rows), (len(slots),),
                          pin=True)
        with torch.cuda.stream(self._io_stream):
            self._io_stream.wait_event(exported)
            for h, r in zip(tree_leaves(host), tree_leaves(rows)):
                r.record_stream(self._io_stream)
                h.copy_(r, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self._io_stream)
        return host, copied

    def _spill_group(self, evicted) -> None:
        """One batched export of every slot this acquire evicts and one
        write-behind .npz for the whole group."""
        cids = [c for c, _ in evicted]
        host, copied = self._export_to_host([s for _, s in evicted])
        path = os.path.join(self.spill_dir,
                            f"group_{self._group_seq:08d}.npz")
        self._group_seq += 1
        self._group_live[path] = set(cids)
        self._group_rows[path] = len(cids)
        with self._io_lock:
            for idx, cid in enumerate(cids):
                self._group_of[cid] = (path, idx)
                self._inflight[cid] = (path, host, idx, copied)
        self.spills += len(cids)

        def _save():
            if copied is not None:
                copied.synchronize()       # the rows' copy, not the device
            save_pytree(host, path)
            with self._io_lock:
                for cid in cids:
                    entry = self._inflight.get(cid)
                    if entry is not None and entry[0] == path:
                        del self._inflight[cid]

        self._save_futs[path] = self._submit(_save)

    def _load_group(self, path: str):
        k = self._group_rows[path]
        template = tree_map(
            lambda f: torch.empty((), dtype=f.dtype).expand(k, *f.shape),
            self._fresh)
        return load_pytree(template, path)

    def _archive(self, path: str):
        """The host row-stack of a group file, from the prefetch cache or a
        synchronous load (waiting out an in-flight save first)."""
        fut = self._archive_futs.pop(path, None)
        if fut is not None:
            self._archive_cache[path] = fut.result()
        arch = self._archive_cache.get(path)
        if arch is None:
            save_fut = self._save_futs.get(path)
            if save_fut is not None:
                save_fut.result()
            arch = self._load_group(path)
            self._archive_cache[path] = arch
        return arch

    def _row_from_group(self, cid: int):
        """One client's spilled host row out of its group (the in-flight
        export, a prefetched archive, or a synchronous file read)."""
        path, idx = self._group_of.pop(cid)
        with self._io_lock:
            entry = self._inflight.pop(cid, None)
        if entry is not None and entry[0] == path:
            if entry[3] is not None:
                entry[3].synchronize()
            row = tree_map(lambda x: x[idx], entry[1])
        else:
            row = tree_map(lambda x: x[idx], self._archive(path))
        live = self._group_live[path]
        live.discard(cid)
        if not live:
            self._drop_group(path)
        return row

    def _drop_group(self, path: str) -> None:
        """Every row of the group restored (or forgotten): delete the file
        once its write has finished."""
        self._group_live.pop(path, None)
        self._group_rows.pop(path, None)
        self._archive_cache.pop(path, None)
        self._archive_futs.pop(path, None)
        save_fut = self._save_futs.pop(path, None)

        def _rm():
            if save_fut is not None:
                save_fut.result()
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass

        self._cleanup_futs.append(self._submit(_rm))

    def prefetch(self, ids) -> None:
        """Warm the restore path for an upcoming chunk: group archives (and
        per-client spills) load into the host cache on the I/O threads."""
        paths = set()
        for cid in (int(c) for c in np.asarray(ids).ravel()):
            if cid not in self._pending:
                continue
            if cid in self._group_of:
                path = self._group_of[cid][0]
                with self._io_lock:
                    in_mem = cid in self._inflight
                if not in_mem and path not in self._archive_cache \
                        and path not in self._archive_futs:
                    paths.add(path)
            elif cid in self._spilled and cid not in self._row_futs:
                self._row_futs[cid] = self._submit(
                    load_pytree, _host_like(self._fresh),
                    self._spill_path(cid))
        for path in paths:
            save_fut = self._save_futs.get(path)

            def _load(path=path, save_fut=save_fut):
                if save_fut is not None:
                    save_fut.result()      # never read a half-written file
                return self._load_group(path)

            self._archive_futs[path] = self._submit(_load)

    def collect_pending(self, ids):
        """Drain this chunk's pending rows: ``(slots, rows)`` — host rows
        (pinned on a CUDA run) stacked along the slot array, fresh rows
        broadcast-filled — or None when every chunk member was resident.
        The caller grafts them with ``state_import_many``."""
        sel = [int(c) for c in np.asarray(ids).ravel()
               if int(c) in self._pending]
        if not sel:
            return None
        slots = np.asarray([self._pending.pop(c) for c in sel], np.int64)
        if self._fresh_host is None:
            self._fresh_host = tree_map(lambda f: f.cpu(), self._fresh)
        bufs = _host_like(self._fresh, (len(sel),), pin=self._cuda)
        fresh_pos = []
        for i, cid in enumerate(sel):
            if cid in self._group_of:
                row = self._row_from_group(cid)
                self.restores += 1
            elif cid in self._spilled:
                fut = self._row_futs.pop(cid, None)
                row = (fut.result() if fut is not None else
                       load_pytree(_host_like(self._fresh),
                                   self._spill_path(cid)))
                self._spilled.discard(cid)
                os.unlink(self._spill_path(cid))
                self.restores += 1
            else:
                fresh_pos.append(i)         # zero-init: broadcast below
                continue
            tree_map(lambda b, r: b[i].copy_(r), bufs, row)
        if fresh_pos:
            pos = torch.as_tensor(fresh_pos, dtype=torch.long)
            # one broadcast assignment per leaf
            tree_map(lambda b, f: b.index_copy_(
                0, pos, f.expand(len(fresh_pos), *f.shape)),
                bufs, self._fresh_host)
        return slots, bufs

    def flush_io(self) -> None:
        """Block until every write-behind spill (and queued cleanup) has
        hit disk — checkpoint/shutdown barrier."""
        for fut in list(self._save_futs.values()):
            fut.result()
        for fut in self._cleanup_futs:
            fut.result()
        self._cleanup_futs = []

    # ----------------------------------------------------------------- churn

    def evict_client(self, cid: int) -> bool:
        """Churn departure: drop ``cid``'s persistent state wherever it
        lives — resident slot (freed), per-client spill file (unlinked) or
        group archive row.  Returns whether the client had any state."""
        cid = int(cid)
        if cid in self._pending:
            raise RuntimeError(
                f"evict_client({cid}) with its deferred acquire still "
                "pending — drain collect_pending first")
        had = False
        if cid in self._slot_of:
            self._free.append(self._slot_of.pop(cid))
            had = True
        if cid in self._spilled:
            self._spilled.discard(cid)
            fut = self._row_futs.pop(cid, None)
            if fut is not None:
                fut.result()
            try:
                os.unlink(self._spill_path(cid))
            except FileNotFoundError:
                pass
            had = True
        if cid in self._group_of:
            path, _ = self._group_of.pop(cid)
            with self._io_lock:
                self._inflight.pop(cid, None)
            live = self._group_live.get(path)
            if live is not None:
                live.discard(cid)
                if not live:
                    self._drop_group(path)
            had = True
        return had


def make_client_store(proto: Optional[ClientStateSpec], params,
                      population_size: int, budget: Optional[int] = None,
                      spill_dir: Optional[str] = None):
    """The store a run needs: None for stateless algorithms, dense when the
    budget covers the population, sparse-LRU otherwise."""
    if proto is None:
        return None
    if budget is None or budget >= population_size:
        return DenseClientStore(proto, params, population_size)
    return ClientStateStore(proto, params, population_size, budget,
                            spill_dir=spill_dir)
