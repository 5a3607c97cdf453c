"""Host-side datasets and the threaded loader — port of
color_transfer_tpu/data/datasets.py.

  * ArtificialTrainValDataset — ``*_L.*`` (gt) / ``*_R.*`` (reference)
    pairs; a random same-location crop; a horizontal flip swaps the views (a
    flipped right view is a left view), a vertical flip keeps them;
    ``image_repeats`` virtual-epoch expansion. The crop and flips of item i
    in epoch e come from ``np.random.SeedSequence((seed, e, i))``, the JAX
    package's stream, so both packages cut the same crops.
  * ArtificialTestDataset — full-size pairs crossed with the 31-distortion
    grid (the distortion is applied at evaluation, data/distortions.py).
  * RealWorldTestDataset — ``*/*_L.* *_LD.* *_R.*`` triplets.

Images decode through data/native_loader.py (the C++ decoder, GIL-free;
PIL when it cannot be built), as in the JAX package: the crop geometry from
the image header, the training crops by the cropped decode (PNG rows past
the crop are not inflated), the test sets whole. Batches leave the loader
as uint8 and the distorted target is synthesised on the device in the train
step.
"""

import queue
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from color_transfer_tpu_torch.data import native_loader
from color_transfer_tpu_torch.data.native_loader import read_image
from color_transfer_tpu_torch.parallel.multihost import host_batch_slice


class ArtificialTrainValDataset:
    def __init__(self, image_dir, crop_size, image_repeats=1, seed=0):
        image_dir = Path(image_dir)
        self.gts = sorted(image_dir.glob("*_L.*"))
        self.references = sorted(image_dir.glob("*_R.*"))
        assert len(self.gts) == len(self.references), (
            f"unpaired stereo images in {image_dir}"
        )
        assert self.gts, f"no *_L.* images in {image_dir}"
        self.crop_size = tuple(crop_size)
        self.image_repeats = image_repeats
        self.seed = seed
        self._epoch = 0
        self._info_cache = {}

    def __len__(self):
        return len(self.gts) * self.image_repeats

    def set_epoch(self, epoch):
        """Advance the augmentation stream; called by the Loader each epoch."""
        self._epoch = int(epoch)

    def __getitem__(self, index):
        rng = np.random.default_rng(
            np.random.SeedSequence(entropy=(self.seed, self._epoch, index))
        )
        return self.sample(index, rng)

    def sample(self, index, rng):
        gt_path = self.gts[index // self.image_repeats]
        ref_path = self.references[index // self.image_repeats]
        ch, cw = self.crop_size
        if gt_path not in self._info_cache:
            self._info_cache[gt_path] = native_loader.image_info(gt_path)
        h, w = self._info_cache[gt_path]
        if h < ch or w < cw:
            raise ValueError(f"image {gt_path} is {h}x{w}, smaller than crop {ch}x{cw}")
        # Inclusive bounds (torchvision RandomCrop): an image exactly the
        # crop's size works and the last position is reachable.
        top = int(rng.integers(0, h - ch + 1))
        left = int(rng.integers(0, w - cw + 1))
        # The cropped decode: PNG inflation stops at row top + ch.
        gt = native_loader.read_image_crop(gt_path, top, left, ch, cw)
        reference = native_loader.read_image_crop(ref_path, top, left, ch, cw)
        if rng.random() > 0.5:
            # A horizontal flip turns a left view into a right view: swap.
            gt, reference = reference[:, ::-1], gt[:, ::-1]
        if rng.random() > 0.5:
            gt, reference = gt[::-1], reference[::-1]
        return {"gt": np.ascontiguousarray(gt), "reference": np.ascontiguousarray(reference)}


class ArtificialTestDataset:
    """Full-size pairs; item i is pair i // 31 with distortion i % 31 of
    the grid (the reference's indexing)."""

    def __init__(self, image_dir, num_distortions=31):
        image_dir = Path(image_dir)
        self.gts = sorted(image_dir.glob("*_L.*"))
        self.references = sorted(image_dir.glob("*_R.*"))
        assert len(self.gts) == len(self.references), (
            f"unpaired stereo images in {image_dir}"
        )
        self.num_distortions = num_distortions

    def __len__(self):
        return len(self.gts) * self.num_distortions

    def __getitem__(self, index):
        pair = index // self.num_distortions
        return {
            "gt": read_image(self.gts[pair]),
            "reference": read_image(self.references[pair]),
            "distortion_idx": index % self.num_distortions,
        }


class RealWorldTestDataset:
    def __init__(self, image_dir):
        image_dir = Path(image_dir)
        self.gts = sorted(image_dir.glob("*/*_L.*"))
        self.targets = sorted(image_dir.glob("*/*_LD.*"))
        self.references = sorted(image_dir.glob("*/*_R.*"))
        assert len(self.gts) == len(self.targets) == len(self.references)

    def __len__(self):
        return len(self.gts)

    def __getitem__(self, index):
        return {
            "gt": read_image(self.gts[index]),
            "target": read_image(self.targets[index]),
            "reference": read_image(self.references[index]),
        }


def _collate(items):
    out = {}
    for key in items[0]:
        vals = [item[key] for item in items]
        out[key] = np.stack(vals) if isinstance(vals[0], np.ndarray) else np.asarray(vals)
    return out


class Loader:
    """Threaded prefetching batch loader (the host half of the pipeline).

    ``process_id`` of ``num_processes`` (a data-parallel rank) loads only
    its rows of each global batch (parallel/multihost.py::host_batch_slice):
    the batches' indices are the world-1 run's, and each item's crop comes
    from (seed, epoch, index), so the rows are those a single process would
    load, and each process decodes 1/N of the images."""

    def __init__(self, dataset, batch_size=1, shuffle=False, num_threads=8,
                 seed=0, drop_last=False, prefetch=4, process_id=0, num_processes=1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_threads = num_threads
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.process_id = process_id
        self.num_processes = num_processes
        self._epoch = 0

    def _rows(self, idxs):
        """This process's rows of one global batch's indices."""
        if self.num_processes == 1:
            return idxs
        start, stop = host_batch_slice(len(idxs), self.process_id, self.num_processes)
        return idxs[start:stop]

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch):
        """The epoch the next iteration runs (resume)."""
        self._epoch = int(epoch)

    def first_batch(self):
        """One batch, synchronously: no producer thread and no epoch bump
        (shape probes)."""
        if len(self.dataset) == 0:
            raise ValueError(
                "cannot probe an empty dataset (no items matched the data "
                "glob — check data_dir)"
            )
        idxs = self._rows(range(min(self.batch_size, len(self.dataset))))
        return _collate([self.dataset[i] for i in idxs])

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self._epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self._epoch)
        self._epoch += 1
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng.shuffle(order)
        batches = [order[i : i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        batches = [self._rows(b) for b in batches]

        q = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def put(item):
            # Notice consumer shutdown instead of blocking on a full queue.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_threads) as pool:
                    for idxs in batches:
                        if stop.is_set():
                            return
                        items = list(pool.map(self.dataset.__getitem__, idxs))
                        if not put(_collate(items)):
                            return
            except BaseException as exc:  # noqa: BLE001
                # Hand decode errors to the consumer instead of deadlocking.
                put(exc)
                return
            put(sentinel)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join(timeout=10.0)
            if thread.is_alive():
                warnings.warn(
                    "Loader producer thread did not exit within 10 s (a dataset "
                    "item is likely hung in decode); its worker pool leaks until "
                    "process exit",
                    RuntimeWarning,
                    stacklevel=2,
                )
