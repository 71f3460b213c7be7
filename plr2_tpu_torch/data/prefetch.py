"""The native data plane and its prefetcher, the port of
plr2_tpu/data/prefetch.py.

Worker threads (or spawned processes) decode frames and run the C++ data
plane (`plr2_tpu_torch.native`: mask -> bbox -> choose -> backproject);
the consumer uploads each prepared sample and applies the train-time
augmentation on the device (`finish_sample`), so host decode overlaps
device compute. `host_prepare` and `host_prepare_raw` are NumPy plus the
native library, equal to JAX's bit for bit.

Every draw depends on the dataset index alone, never on which worker made
the sample: the choose seed is `seed * 100003 + i` (JAX's), a dataset
whose `get_raw` takes `rng` (YCB) gets a NumPy generator seeded from
(seed, i) for its per-visit draws, and `iterate_prefetch_samples` draws
sample i's augmentation (`preprocess.Draws`) from a `torch.Generator`
seeded from (one draw of the caller's generator, i), as JAX folds the
dataset index into its key. So 0 workers, threads and processes give the
same samples bit for bit. There is no fallback: if the native library
cannot be built, the first sample raises with the compiler's output.
"""

from __future__ import annotations

import inspect
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from plr2_tpu_torch.data.preprocess import (IMAGENET_MEAN, IMAGENET_STD, Draws,
                                            Sample, _normalize01,
                                            apply_jitter_ops, draw)
from plr2_tpu_torch.geometry.pointcloud import transform_points


def _native_geometry(raw: Dict, num_points: int, seed: int):
    """Native-plane geometry: bbox (from bbox_mask when the loader
    distinguishes it: upstream crops around the label alone), choose
    sampling over the depth-valid mask, depth backprojection.

    -> (cloud, choose, (rmin, rmax, cmin, cmax), count)"""
    from plr2_tpu_torch import native

    intr = raw["intrinsics"]
    bbox_mask = raw.get("bbox_mask")
    if bbox_mask is not None and bbox_mask is not raw["mask"]:
        bbox = native.mask_bbox(bbox_mask)
        choose, count = native.choose_in_bbox(raw["mask"], bbox, num_points,
                                              seed=seed)
    else:
        bbox, choose, count = native.mask_bbox_choose(
            raw["mask"], num_points, seed=seed)
    rmin, rmax, cmin, cmax = bbox
    depth_crop = np.asarray(raw["depth"][rmin:rmax, cmin:cmax], np.float32)
    cloud = native.backproject(
        depth_crop, choose, cmax - cmin, rmin, cmin,
        intr["cx"], intr["cy"], intr["fx"], intr["fy"], intr["cam_scale"])
    return cloud, choose, bbox, count


def host_prepare(raw: Dict, num_points: int, seed: int = 0) -> Dict:
    """Full host-side sample prep via the native data plane (no
    augmentation: the eval-path shape).

    Returns numpy arrays ready for device upload: img (normalized crop),
    points, choose, target, model_points, idx.
    """
    cloud, choose, (rmin, rmax, cmin, cmax), count = _native_geometry(
        raw, num_points, seed)
    img = raw["color"][rmin:rmax, cmin:cmax].astype(np.float32) / 255.0
    img = (img - np.asarray(IMAGENET_MEAN, np.float32)) / np.asarray(
        IMAGENET_STD, np.float32)
    target = raw["model_points"] @ raw["target_r"].T + raw["target_t"]
    return dict(
        points=cloud, choose=choose, img=img,
        target=target.astype(np.float32),
        model_points=np.asarray(raw["model_points"], np.float32),
        idx=np.int32(raw["obj_idx"]), mask_count=count)


def host_prepare_raw(raw: Dict, num_points: int, seed: int = 0) -> Dict:
    """Training-path host prep: native geometry plane only; color stays
    uint8 and the pose stays (R, t) so `finish_sample` can apply the
    reference's train-time augmentation (ColorJitter + translation noise)
    on the device after upload."""
    cloud, choose, (rmin, rmax, cmin, cmax), count = _native_geometry(
        raw, num_points, seed)
    return dict(
        points=cloud, choose=choose,
        img_u8=np.ascontiguousarray(raw["color"][rmin:rmax, cmin:cmax]),
        model_points=np.asarray(raw["model_points"], np.float32),
        target_r=np.asarray(raw["target_r"], np.float32),
        target_t=np.asarray(raw["target_t"], np.float32),
        idx=np.int32(raw["obj_idx"]), mask_count=count)


def finish_sample(img_u8: torch.Tensor, points: torch.Tensor,
                  choose: torch.Tensor, model_points: torch.Tensor,
                  target_r: torch.Tensor, target_t: torch.Tensor, obj_idx: int,
                  draws: Draws, add_noise: bool = False) -> Sample:
    """Device tail for native-prepared samples, on the device of the
    tensors: ColorJitter + translation noise (train) from `draws`, and the
    ImageNet normalisation; the augmentation of `preprocess_crop`, applied
    after upload."""
    dev = img_u8.device
    img01 = img_u8.float() / 255.0
    if add_noise:
        img01 = apply_jitter_ops(img01, draws.factors, draws.order)
        add_t = draws.add_t.float().to(dev)
        points = points + add_t
    else:
        add_t = torch.zeros(3, device=dev)
    target = transform_points(model_points.float(), target_r.float(),
                              target_t.float()) + add_t
    return Sample(points=points, choose=choose.long(), img=_normalize01(img01),
                  target=target, model_points=model_points.float(),
                  idx=torch.tensor(int(obj_idx), device=dev), obj=int(obj_idx))


def index_seed(base: int, i: int) -> int:
    """A 63-bit seed mixed from (base, i)."""
    state = np.random.SeedSequence([int(base), int(i)]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def get_raw_at(dataset, i: int, seed: int) -> Dict:
    """`dataset.get_raw(i)`; a dataset whose get_raw takes `rng` (per-visit
    draws, as YCB's) gets a generator seeded from (seed, i)."""
    if "rng" in inspect.signature(dataset.get_raw).parameters:
        return dataset.get_raw(i, rng=np.random.default_rng([int(seed), int(i)]))
    return dataset.get_raw(i)


def prepare(dataset, i: int, num_points: int, seed: int, raw_mode: bool) -> Dict:
    """Sample i through the native plane (host_prepare_raw with its dataset
    index under "index", or host_prepare)."""
    raw = get_raw_at(dataset, i, seed)
    if raw_mode:
        return dict(host_prepare_raw(raw, num_points, seed=seed * 100003 + i),
                    index=i)
    return host_prepare(raw, num_points, seed=seed * 100003 + i)


# --- process-worker plumbing (module level so 'spawn' can pickle it) ---
_PROC_STATE: Dict = {}


def _proc_init(dataset, num_points: int, seed: int, raw_mode: bool):
    torch.set_num_threads(1)
    _PROC_STATE.update(dataset=dataset, num_points=num_points, seed=seed,
                       raw_mode=raw_mode)


def _proc_work(i: int) -> Dict:
    st = _PROC_STATE
    return prepare(st["dataset"], int(i), st["num_points"], st["seed"],
                   st["raw_mode"])


class PrefetchLoader:
    """Iterate prepared samples with `num_workers` background workers,
    delivered in submission order.

    `raw_mode=False` (default): host_prepare dicts (fully normalised, no
    augmentation). `raw_mode=True`: host_prepare_raw dicts (uint8 crop +
    pose, for the device-side augmentation of `finish_sample`), each with
    its dataset index under "index".

    `use_processes=True` runs the workers as SPAWNED processes (the
    reference's torch DataLoader model): the pool is made at the first
    epoch and reused until `close()`; the dataset must pickle (a frame
    cache arrives empty in each worker), and spawn re-imports the caller's
    `__main__`, which must be import-safe. Threads suffice where decode
    releases the GIL (zlib, the native library, NumPy)."""

    _pool = None

    def __init__(self, dataset, num_points: int, num_workers: int = 4,
                 prefetch: int = 16, shuffle: bool = False, seed: int = 0,
                 raw_mode: bool = False, use_processes: bool = False):
        self.dataset = dataset
        self.num_points = num_points
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.shuffle = shuffle
        self.seed = seed
        self.raw_mode = raw_mode
        self.use_processes = use_processes

    def __len__(self) -> int:
        return len(self.dataset)

    def _order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed).shuffle(order)
        return order

    def close(self) -> None:
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __del__(self):
        self.close()

    def _iter_processes(self) -> Iterator[Dict]:
        import multiprocessing as mp

        if self._pool is None:
            self._pool = mp.get_context("spawn").Pool(
                self.num_workers, initializer=_proc_init,
                initargs=(self.dataset, self.num_points, self.seed,
                          self.raw_mode))
        # imap keeps submission order
        yield from self._pool.imap(_proc_work, [int(i) for i in self._order()],
                                   chunksize=4)

    def __iter__(self) -> Iterator[Dict]:
        if self.use_processes:
            yield from self._iter_processes()
            return
        order = self._order()
        work: "queue.Queue[Optional[int]]" = queue.Queue()
        done: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        for i in order:
            work.put(int(i))
        for _ in range(self.num_workers):
            work.put(None)

        def worker():
            while not stop.is_set():
                i = work.get()
                if i is None:
                    done.put(None)
                    return
                try:
                    s = prepare(self.dataset, i, self.num_points, self.seed,
                                self.raw_mode)
                    done.put(("ok", i, s))
                except Exception as e:  # raised on the consumer side
                    done.put(("err", i, e))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        pos_of = {int(i): p for p, i in enumerate(order)}
        pending, next_pos, finished = {}, 0, 0
        try:
            while finished < self.num_workers or pending:
                if next_pos in pending:
                    kind, item = pending.pop(next_pos)
                    next_pos += 1
                    if kind == "err":  # raised in its place in the order
                        raise item
                    yield item
                    continue
                msg = done.get()
                if msg is None:
                    finished += 1
                    continue
                kind, i, payload = msg
                pending[pos_of[i]] = (kind, payload)
        finally:
            # a consumer that stops early: let the workers finish the item
            # in hand and leave
            stop.set()
            while any(t.is_alive() for t in threads):
                try:
                    done.get(timeout=0.05)
                except queue.Empty:
                    pass


def iterate_prefetch_samples(dataset, generator: torch.Generator,
                             num_points: int, add_noise: bool = False,
                             noise_trans: float = 0.03, shuffle: bool = False,
                             seed: int = 0, num_workers: int = 4,
                             device="cpu",
                             use_processes: bool = False) -> Iterator[Sample]:
    """Samples over the native data plane: workers decode and run the C++
    mask -> bbox -> choose -> backproject, the consumer uploads to `device`
    and applies the augmentation there (`finish_sample`).

    Takes one draw of `generator`; sample i's `Draws` come from a generator
    seeded from (that draw, i). `num_workers=0` prepares in the calling
    thread; its samples equal the threaded and process runs' bit for bit."""
    base = int(torch.randint(0, 2 ** 62, (1,), generator=generator))

    def finish(prep) -> Sample:
        i = prep["index"]
        d = draw(torch.Generator().manual_seed(index_seed(base, i)), noise_trans)

        def up(k):  # a cached frame's crop may be a read-only view
            a = prep[k]
            return torch.from_numpy(a if a.flags.writeable else a.copy()).to(device)
        return finish_sample(up("img_u8"), up("points"), up("choose"),
                             up("model_points"), up("target_r"),
                             up("target_t"), int(prep["idx"]), d,
                             add_noise=add_noise)

    if num_workers <= 0:
        order = np.arange(len(dataset))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for i in order:
            yield finish(prepare(dataset, int(i), num_points, seed, True))
        return
    loader = PrefetchLoader(dataset, num_points, num_workers=num_workers,
                            shuffle=shuffle, seed=seed, raw_mode=True,
                            use_processes=use_processes)
    try:
        for prep in loader:
            yield finish(prep)
    finally:
        loader.close()
