"""PyTorch/CUDA port of Volume Segmantics.

Mirrors the module tree and public names of the JAX package
`volume_segmantics_tpu`, which stays the numerical reference. Plain tensor
code is PyTorch; the three on-device augmentation kernels (warp, CLAHE LUTs,
CLAHE blend) are hand-written CUDA C++ for Hopper (`ops/csrc`), built with
nvcc at first CUDA use. Entry points run on `device="cuda"` unless the
caller passes another device, and raise when no GPU is present.

Ported so far: both console entry points (`scripts.train_2d_model`,
`scripts.predict_2d_model`, installed as `model-train-2d-torch` and
`model-predict-2d-torch`) with the settings files and HDF5 volumes they
read and write (`utils.yaml_settings`, `utils.hdf5`: the port's own
readers, no PyYAML or h5py); the training path (`data.TrainingDataSlicer`,
`model.VolSeg2dTrainer`, U-Net/ResNet-34, Dice loss and MeanIoU); and
3-D prediction (`model.VolSeg2DPredictionManager`, at every quality,
max-prob or one-hot), in the GPU's memory or, for volumes beyond it,
slab-streamed from a lazily read HDF5 file into host memmaps; prediction
launches none of the kernels.
"""

__version__ = "0.1.0"
