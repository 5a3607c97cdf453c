"""DataModule — port of color_transfer_tpu/run/datamodule.py.

Layout under ``data_dir`` (the reference's):
    Train/              NNNN_L.png NNNN_R.png          (train crops)
    Validation/         NNNN_L.png NNNN_R.png          (val crops)
    Test/               NNNN_L.png NNNN_R.png          (31-distortion grid)
    Real-World Test/    scene*/NNNN_{L,LD,R}.png       (real distortions)

Validation and test each produce up to two loaders (artificial,
real-world) like the reference. Batches leave the loaders as uint8; ``to_float`` normalises them
to channel-last float32 in [0, 1].
"""

from pathlib import Path

import numpy as np

from color_transfer_tpu_torch.data import datasets


def to_float(batch):
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.dtype == np.uint8:
            out[k] = v.astype(np.float32) / 255.0
        else:
            out[k] = v
    return out


class DataModule:
    def __init__(self, data_dir, crop_size=(160, 320), image_repeats=1, batch_size=8,
                 num_workers=8, seed=42):
        self.data_dir = Path(data_dir)
        self.crop_size = tuple(crop_size)
        self.image_repeats = image_repeats
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.seed = seed

    def train_loader(self, process_id=0, num_processes=1):
        """The shuffled training batches of ``batch_size`` (the global
        batch); a data-parallel rank (``process_id`` of ``num_processes``)
        loads its rows of each."""
        ds = datasets.ArtificialTrainValDataset(
            self.data_dir / "Train", self.crop_size, self.image_repeats, seed=self.seed,
        )
        return datasets.Loader(ds, batch_size=self.batch_size, shuffle=True,
                               num_threads=self.num_workers, seed=self.seed,
                               drop_last=True, process_id=process_id,
                               num_processes=num_processes)

    def val_loaders(self):
        loaders = []
        art_dir = self.data_dir / "Validation"
        if art_dir.exists():
            ds = datasets.ArtificialTrainValDataset(
                art_dir, self.crop_size, self.image_repeats, seed=self.seed + 1
            )
            loaders.append(datasets.Loader(ds, batch_size=self.batch_size,
                                           num_threads=self.num_workers, seed=self.seed))
        rw_dir = self.data_dir / "Real-World Test"
        if rw_dir.exists():
            loaders.append(datasets.Loader(datasets.RealWorldTestDataset(rw_dir),
                                           batch_size=1, num_threads=self.num_workers))
        return loaders

    def test_loaders(self):
        """The full-size artificial set (``Test/``, each pair x the 31
        distortions) and the real-world set, each at batch 1."""
        loaders = []
        art_dir = self.data_dir / "Test"
        if art_dir.exists():
            loaders.append(datasets.Loader(datasets.ArtificialTestDataset(art_dir),
                                           batch_size=1, num_threads=self.num_workers))
        rw_dir = self.data_dir / "Real-World Test"
        if rw_dir.exists():
            loaders.append(datasets.Loader(datasets.RealWorldTestDataset(rw_dir),
                                           batch_size=1, num_threads=self.num_workers))
        return loaders
