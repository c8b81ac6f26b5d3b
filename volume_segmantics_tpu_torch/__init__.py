"""PyTorch/CUDA port of Volume Segmantics.

Mirrors the module tree and public names of the JAX package
`volume_segmantics_tpu`, which stays the numerical reference. Plain tensor
code is PyTorch; the three on-device augmentation kernels (warp, CLAHE LUTs,
CLAHE blend) are hand-written CUDA C++ for Hopper (`ops/csrc`), built with
nvcc at first CUDA use. Entry points run on `device="cuda"` unless the
caller passes another device, and raise when no GPU is present.

Ported so far: the training path (`model.VolSeg2dTrainer` on in-memory
slice lists, U-Net/ResNet-34, Dice loss and MeanIoU) and in-memory 3-D
prediction (`model.VolSeg2DPredictionManager` on an ndarray, at every
quality, max-prob or one-hot), which launches none of the kernels.
"""

__version__ = "0.1.0"
