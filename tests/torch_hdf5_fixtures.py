"""Writes the HDF5 fixtures of tests/data/torch_hdf5/ with h5py, for the
machine that has no h5py: `chip_smoke.py`'s interchange phase reads them
there and holds each against its array, rebuilt by
`chip_smoke.fixture_arrays()`; `tests/test_torch_hdf5_fixtures.py` holds
them against h5py's reading here. `chip_smoke.FIXTURE_READS` lists the
files and what each holds.

    python tests/torch_hdf5_fixtures.py

The committed files were written with h5py 3.14.0 on HDF5 1.14.6.
"""

import sys
from pathlib import Path

import h5py
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

NEXUS_PATH = "entry/final_result_tomo/data"


def write_fixtures(folder: Path) -> None:
    folder.mkdir(parents=True, exist_ok=True)
    arrays = chip_smoke.fixture_arrays()
    vol, labels, crop = arrays["vessels"], arrays["labels"], arrays["crop"]

    # The volume in a superblock 3 file: one unlimited axis (an extensible
    # array), shuffle + gzip + Fletcher-32.
    with h5py.File(folder / "vessels_latest.h5", "w", libver="latest") as f:
        f.create_dataset("data", data=vol, chunks=(8, 48, 48),
                         maxshape=(None, 96, 96), shuffle=True,
                         compression="gzip", fletcher32=True)
    # The NeXus file: track-ordered groups; final_result_tomo holds 13
    # links (dense: a fractal heap behind B-trees of names and creation
    # order), its data an external link into the file above.
    with h5py.File(folder / "vessels.nxs", "w", track_order=True) as f:
        entry = f.create_group("entry", track_order=True)
        entry.attrs["NX_class"] = "NXentry"
        entry["title"] = np.bytes_("synthetic vessels")
        tomo = entry.create_group("final_result_tomo", track_order=True)
        tomo.attrs["NX_class"] = "NXdata"
        tomo.attrs["signal"] = "data"
        for axis, size in zip("zyx", vol.shape):
            tomo[axis] = np.arange(size, dtype="<f4") * 0.5
        for i in range(9):
            tomo[f"parameter_{i}"] = np.float64(i)
        tomo["data"] = h5py.ExternalLink("vessels_latest.h5", "/data")
    # The labels in a fixed array (superblock 3, gzip).
    with h5py.File(folder / "vessels_labels.h5", "w", libver="latest") as f:
        f.create_dataset("data", data=labels, chunks=(8, 48, 48),
                         compression="gzip")

    # One small file for each other chunk index and variant.
    with h5py.File(folder / "single_chunk.h5", "w", libver="latest") as f:
        f.create_dataset("data", data=crop, chunks=crop.shape,
                         compression="gzip", fletcher32=True)
    with h5py.File(folder / "implicit.h5", "w", libver="latest") as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((5, 10, 10))
        dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
        h5py.h5d.create(f.id, b"data", h5py.h5t.STD_U8LE,
                        h5py.h5s.create_simple(crop.shape), dcpl=dcpl)
        f["data"][...] = crop
    with h5py.File(folder / "fixed_array_paged.h5", "w", libver="latest") as f:
        f.create_dataset("data", data=crop, chunks=(1, 1, 6))  # 1,152 chunks
    with h5py.File(folder / "btree2.h5", "w", libver="latest") as f:
        f.create_dataset("data", data=crop, chunks=(5, 10, 10),
                         maxshape=(None, None, 24), compression="gzip")
    with h5py.File(folder / "contiguous_latest.h5", "w", libver="latest") as f:
        f.create_dataset("data", data=crop)
    with h5py.File(folder / "superblock_2.h5", "w", libver=("v108", "latest")) as f:
        f.create_dataset("data", data=crop, chunks=(5, 10, 10), compression="gzip")
    with h5py.File(folder / "user_block.h5", "w", userblock_size=512) as f:
        f.create_dataset("data", data=crop, chunks=True, compression="gzip")
    with h5py.File(folder / "soft_link.nxs", "w") as f:
        f.create_dataset("raw/data", data=crop, chunks=True, compression="gzip")
        f[NEXUS_PATH] = h5py.SoftLink("/raw/data")


if __name__ == "__main__":
    write_fixtures(Path(chip_smoke.FIXTURE_DIR))
