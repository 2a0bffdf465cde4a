"""Batched loading of mapped pairs with background prefetch (counterpart of
the JAX package's `data/loader.py:PairLoader`; numpy only).

Replaces detectron2's build_detection_train_loader (train_NopeSAC.py:73-85).
Pairs are mapped to fixed-shape numpy samples either in a producer thread
(num_workers=0) or in a pool of worker processes (num_workers>0, the
reference's DATALOADER.NUM_WORKERS: PIL decoding, RLE and mask rasterising
hold the GIL), and collated batches are prefetched through a bounded queue.
Each epoch shuffles with `default_rng(seed + epoch)`; `num_shards` /
`shard_id` take a strided slice of the dataset (index % num_shards ==
shard_id), like detectron2's per-rank sampler; `infinite` runs epoch after
epoch. An exception in the producer or in a worker is raised again in the
consumer. Item k of an iterator gets the augmentation seed
seed * 1_000_003 + k, so the pool and the thread give the same samples.

The pool is started with `spawn`: the parent has CUDA initialised and runs
threads, and a forked child would inherit both. Each worker gets the mapper
and unpickles the dataset from one shared-memory copy; this module and the
mapper import no torch, so workers touch no torch.cuda. A mapped
sample is ~14 MB at 480x640 (two f32 images, depth and bit-packed masks),
so workers write its arrays into a SharedMemory slab ring and return only
small descriptors; the producer copies a batch out of the ring with one
strided copy per key. Each iterator owns its ring (two batches of slots),
so iterators that are live at once, such as the training stream and a
precise-BN pass, never share slots. The ring is unlinked by its own
producer thread once that thread is done with it. `close()` stops the
producers, terminates the pool, joins the producer threads (never the
calling thread itself) and unlinks the dataset's copy.
"""
from __future__ import annotations

import pickle
import queue
import threading
from multiprocessing import shared_memory
from typing import Callable, Dict, Iterator, List

import numpy as np

from .mapper import collate

# arrays at or above this size travel through the ring; smaller values
# (metas, tiny vectors) ride the result pickle
_SHM_MIN_BYTES = 4096
PREFETCH = 2  # collated batches queued ahead of the consumer
_WORKER: Dict = {}  # a pool worker's mapper, dataset and attached rings


def _init_worker(mapper, dataset_name: str, nbytes: int):
    """Unpickle the dataset from the parent's shared-memory copy."""
    shm = shared_memory.SharedMemory(name=dataset_name)
    view = shm.buf[:nbytes]
    dataset = pickle.loads(view)
    view.release()
    shm.close()
    _WORKER.update(mapper=mapper, dataset=dataset, rings={})


def _ring(name: str) -> shared_memory.SharedMemory:
    """The ring `name`, attached once per worker (the last two kept: a
    training stream and a precise-BN pass can be live at once)."""
    rings = _WORKER["rings"]
    if name not in rings:
        while len(rings) >= 2:
            rings.pop(next(iter(rings))).close()
        rings[name] = shared_memory.SharedMemory(name=name)
    return rings[name]


def _flatten(sample: Dict):
    """[(path, value)] with path (key,) or (key, subkey)."""
    out = []
    for k, v in sample.items():
        if isinstance(v, dict) and k != "meta":
            out.extend(((k, sk), sv) for sk, sv in v.items())
        else:
            out.append(((k,), v))
    return out


def _in_ring(v) -> bool:
    return isinstance(v, np.ndarray) and v.nbytes >= _SHM_MIN_BYTES and v.dtype != object


def _map_item(args):
    """Map dataset item `idx` in a worker and write its large arrays into
    slot `slot` of ring `ring`: (slot, [(path, shape, dtype, offset)],
    [(path, small value)])."""
    idx, seed, ring, slot, slot_bytes = args
    sample = _WORKER["mapper"](_WORKER["dataset"][idx], aug_seed=seed)
    buf = _ring(ring).buf
    off, descrs, small = 0, [], []
    for path, v in _flatten(sample):
        if not _in_ring(v):
            small.append((path, v))
            continue
        if off + v.nbytes > slot_bytes:
            raise ValueError(f"ring slot overflow at {path}: {off + v.nbytes} > {slot_bytes} bytes")
        np.copyto(np.ndarray(v.shape, v.dtype, buffer=buf, offset=slot * slot_bytes + off), v)
        descrs.append((path, v.shape, v.dtype.str, off))
        off += v.nbytes
    return slot, descrs, small


def _put_path(tree: Dict, path, v) -> None:
    if len(path) == 1:
        tree[path[0]] = v
    else:
        tree.setdefault(path[0], {})[path[1]] = v


class _Stopped(Exception):
    """The consumer stopped the iterator, or the loader was closed."""


class _ProducerError:
    """Queue envelope of an exception raised by the producer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class PairLoader:
    def __init__(self, dataset: List[dict], mapper: Callable, batch_size: int,
                 shuffle: bool = True, drop_last: bool = True, seed: int = 42,
                 num_shards: int = 1, shard_id: int = 0, infinite: bool = False,
                 num_workers: int = 0):
        self.dataset = dataset[shard_id::num_shards] if num_shards > 1 else dataset
        self.mapper = mapper
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.infinite = infinite
        self._pool = None
        self._dataset_shm = None
        self._slot_bytes = 0
        self._producers: List = []
        self._rings: set = set()  # names of the live iterators' rings
        if num_workers > 0 and len(self.dataset):
            import multiprocessing as mp

            # every sample has the same arrays (fixed shapes): size a slot
            # from one, with 25% + 64 KiB of headroom; a worker raises on
            # an overflow instead of writing past its slot
            probe = mapper(self.dataset[0], aug_seed=seed * 1_000_003 - 1)
            nbytes = sum(int(v.nbytes) for _, v in _flatten(probe) if _in_ring(v))
            self._slot_bytes = -(-(int(nbytes * 1.25) + 65536) // 4096) * 4096
            # the dataset goes to the workers through shared memory, not in
            # the initializer's arguments: a spawned child reads those only
            # after its start-up imports, and the parent, writing more than
            # a pipe holds, would wait for each child in turn
            blob = pickle.dumps(self.dataset, protocol=pickle.HIGHEST_PROTOCOL)
            self._dataset_shm = shared_memory.SharedMemory(create=True, size=len(blob))
            self._dataset_shm.buf[:len(blob)] = blob
            self._pool = mp.get_context("spawn").Pool(
                num_workers, initializer=_init_worker,
                initargs=(mapper, self._dataset_shm.name, len(blob)))

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        return idx

    # ------------------------------------------------------------ producer
    def _start(self, chunk, first_item: int, ring, parity: int):
        """Map `chunk` (dataset indices): in this thread without a pool, or
        dispatched to the pool into the ring's `parity` half."""
        seeds = [self.seed * 1_000_003 + first_item + k for k in range(len(chunk))]
        if self._pool is None:
            return [self.mapper(self.dataset[i], aug_seed=s) for i, s in zip(chunk, seeds)]
        base = parity * self.batch_size
        try:
            return self._pool.map_async(_map_item, [
                (int(i), s, ring.name, base + k, self._slot_bytes)
                for k, (i, s) in enumerate(zip(chunk, seeds))])
        except ValueError:  # "Pool not running": close() under this thread
            if self._pool is None:
                raise _Stopped()
            raise

    def _finish(self, started, ring, stop: threading.Event) -> Dict:
        """Collate a started chunk. From the ring: each array key is one
        strided view over the chunk's consecutive slots, copied out at once."""
        if isinstance(started, list):
            return collate(started)
        while not started.ready():
            if stop.is_set():
                raise _Stopped()
            started.wait(0.5)
        rets = started.get()
        slot0, descrs0, _ = rets[0]
        batch: Dict = {"meta": []}
        n = len(rets)
        for path, shape, dtype, off in descrs0:
            dt = np.dtype(dtype)
            strides = [dt.itemsize]
            for s in reversed(shape[1:]):
                strides.insert(0, strides[0] * s)
            view = np.ndarray((n,) + tuple(shape), dt, buffer=ring.buf,
                              offset=slot0 * self._slot_bytes + off,
                              strides=(self._slot_bytes,) + tuple(strides))
            # a copy: the slots are reused two batches later
            _put_path(batch, path, view.copy())
            del view
        smalls: Dict = {}
        for _, descrs, small in rets:
            if [d[1:] for d in descrs] != [d[1:] for d in descrs0]:
                raise ValueError("samples of one batch have different array layouts")
            for path, v in small:
                if path == ("meta",):
                    batch["meta"].append(v)
                else:
                    smalls.setdefault(path, []).append(v)
        for path, vals in smalls.items():
            _put_path(batch, path, np.stack(vals))
        return batch

    def _produce(self, q: "queue.Queue", stop: threading.Event):
        ring = None
        if self._pool is not None:
            ring = shared_memory.SharedMemory(
                create=True, size=self._slot_bytes * self.batch_size * 2)
            self._rings.add(ring.name)

        def put(item) -> None:
            # bounded put that gives up once the consumer has stopped
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return
                except queue.Full:
                    continue
            raise _Stopped()

        try:
            epoch, item = 0, 0
            while True:
                idx = self._epoch_indices(epoch)
                # double-buffered: the pool maps chunk b + 1 while this
                # thread collates chunk b out of the ring's other half
                pending = None
                for b in range(len(self)):
                    chunk = idx[b * self.batch_size:(b + 1) * self.batch_size]
                    if stop.is_set():
                        raise _Stopped()
                    started = self._start(chunk, item, ring, b % 2)
                    item += len(chunk)
                    if pending is not None:
                        put(self._finish(pending, ring, stop))
                    pending = started
                if pending is not None:
                    put(self._finish(pending, ring, stop))
                if not self.infinite:
                    put(None)
                    return
                epoch += 1
        except _Stopped:
            pass
        except Exception as e:  # reaches the consumer, which would wait forever
            try:
                put(_ProducerError(e))
            except _Stopped:
                pass
        finally:
            if ring is not None:
                ring.close()
                ring.unlink()
                self._rings.discard(ring.name)

    # ------------------------------------------------------------ consumer
    def __iter__(self) -> Iterator[Dict]:
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()
        t = threading.Thread(target=self._produce, args=(q, stop), daemon=True)
        self._producers.append((t, stop))
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, _ProducerError):
                    raise RuntimeError("data loader producer failed") from batch.exc
                yield batch
        finally:
            stop.set()

    def close(self):
        """Stop every producer, terminate the pool (a producer waiting on it
        then stops) and join the producer threads."""
        for _, stop in self._producers:
            stop.set()
        if self._pool is not None:
            self._pool.terminate()
            self._pool = None
        for t, _ in self._producers:
            # close() can run in a producer thread (a __del__ there); a
            # thread cannot join itself
            if t is not threading.current_thread():
                t.join(timeout=5.0)
        self._producers = [(t, s) for t, s in self._producers if t.is_alive()]
        if self._dataset_shm is not None:
            self._dataset_shm.close()
            self._dataset_shm.unlink()
            self._dataset_shm = None

    def __del__(self):
        self.close()
