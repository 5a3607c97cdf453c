"""DataModule — port of color_transfer_tpu/run/datamodule.py (training and
validation loaders).

Layout under ``data_dir`` (the reference's):
    Train/              NNNN_L.png NNNN_R.png          (train crops)
    Validation/         NNNN_L.png NNNN_R.png          (val crops)
    Real-World Test/    scene*/NNNN_{L,LD,R}.png       (real distortions)

Validation produces up to two loaders (artificial, real-world) like the
reference. Batches leave the loaders as uint8; ``to_float`` normalises them
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

    def train_loader(self):
        ds = datasets.ArtificialTrainValDataset(
            self.data_dir / "Train", self.crop_size, self.image_repeats, seed=self.seed,
        )
        return datasets.Loader(ds, batch_size=self.batch_size, shuffle=True,
                               num_threads=self.num_workers, seed=self.seed,
                               drop_last=True)

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
