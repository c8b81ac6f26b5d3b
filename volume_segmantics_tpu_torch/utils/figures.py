"""The trainer's two figures, rasterised in numpy (the GPU machine has no
matplotlib): the loss plot and the validation montage. Text (axis labels,
legend, titles) goes into the PNG's tEXt chunks, not into the pixels.
"""

import numpy as np

WHITE, BLACK = (255, 255, 255), (0, 0, 0)
GAP = 4  # white pixels around each panel of a montage
# matplotlib's first two cycle colours (C0, C1) and "r".
C0, C1, RED = (31, 119, 180), (255, 127, 14), (255, 0, 0)


class Axes:
    """An axes box on a `height` x `width` RGB canvas: data limits
    `xlim` and `ylim` map linearly onto the box's pixel columns and rows
    (y up), as matplotlib's default figure of 10 x 8 inches at 100 dpi."""

    def __init__(self, xlim, ylim, width=1000, height=800,
                 box=(40, 100, 720, 960)):
        self.xlim, self.ylim = xlim, ylim
        self.top, self.left, self.bottom, self.right = box
        self.canvas = np.full((height, width, 3), WHITE, np.uint8)
        self._frame()

    def col(self, x):
        x0, x1 = self.xlim
        return self.left + (np.asarray(x, float) - x0) / (x1 - x0) * (
            self.right - self.left)

    def row(self, y):
        y0, y1 = self.ylim
        return self.bottom - (np.asarray(y, float) - y0) / (y1 - y0) * (
            self.bottom - self.top)

    def _frame(self):
        c = self.canvas
        c[self.top, self.left:self.right + 1] = BLACK
        c[self.bottom, self.left:self.right + 1] = BLACK
        c[self.top:self.bottom + 1, self.left] = BLACK
        c[self.top:self.bottom + 1, self.right] = BLACK

    def xticks(self, xs, length=5):
        for col in np.rint(self.col(xs)).astype(int):
            self.canvas[self.bottom + 1:self.bottom + 1 + length, col] = BLACK

    def line(self, xs, ys, colour, width=2, dash=None):
        """A polyline through the data points, `width` pixels wide; `dash`
        = (on, off) pixels along its length for a dashed line."""
        cols, rows = self.col(xs), self.row(ys)
        travelled = 0.0
        for c0, r0, c1, r1 in zip(cols, rows, cols[1:], rows[1:]):
            length = float(np.hypot(c1 - c0, r1 - r0))
            t = np.linspace(0.0, 1.0, int(np.ceil(length * 4)) + 2)
            cs, rs = c0 + t * (c1 - c0), r0 + t * (r1 - r0)
            if dash is not None:
                keep = (travelled + t * length) % sum(dash) < dash[0]
                cs, rs = cs[keep], rs[keep]
            travelled += length
            self._dots(cs, rs, colour, width)

    def _dots(self, cs, rs, colour, width):
        lo = -(width // 2)
        offsets = np.arange(lo, lo + width)
        rr = (np.rint(rs)[:, None, None] + offsets[None, :, None]).astype(int)
        cc = (np.rint(cs)[:, None, None] + offsets[None, None, :]).astype(int)
        rr, cc = np.broadcast_arrays(rr, cc)
        inside = ((rr >= self.top) & (rr <= self.bottom)
                  & (cc >= self.left) & (cc <= self.right))
        self.canvas[rr[inside], cc[inside]] = colour


def loss_plot(train_losses, valid_losses) -> tuple:
    """The loss figure of the JAX trainer (`output_loss_fig`): training
    and validation loss by epoch (1-based) in C0 and C1, a dashed red line
    at the best epoch, argmin(valid) + 1, x limits (0, epochs + 1) and
    ticks at each epoch. Returns (RGB canvas, its Axes, the best epoch)."""
    epochs = np.arange(1, len(train_losses) + 1)
    values = np.concatenate([train_losses, valid_losses]).astype(float)
    lo, hi = float(values.min()), float(values.max())
    pad = (hi - lo) * 0.05 or 0.5
    axes = Axes((0, len(epochs) + 1), (lo - pad, hi + pad))
    axes.xticks(epochs)
    axes.line(epochs, train_losses, C0)
    axes.line(epochs, valid_losses, C1)
    best = int(np.argmin(valid_losses)) + 1
    axes.line([best, best], axes.ylim, RED, dash=(8, 3))
    return axes.canvas, axes, best


def to_grey(panel) -> np.ndarray:
    """A panel min-max scaled to 0-255 as ``imshow(cmap="gray")`` shows
    it: the 256-entry grey map indexed by floor(256 (v - min) / (max -
    min)), clipped to 255; a constant panel is black."""
    panel = np.asarray(panel, np.float64)
    lo, hi = panel.min(), panel.max()
    if hi == lo:
        return np.zeros(panel.shape, np.uint8)
    return np.minimum(np.floor((panel - lo) / (hi - lo) * 256), 255).astype(
        np.uint8)


def panel_origin(row: int, col: int, shape) -> tuple:
    """The top-left pixel of panel (row, col) of `shape` in a `montage`."""
    return GAP + row * (shape[0] + GAP), GAP + col * (shape[1] + GAP)


def montage(rows) -> np.ndarray:
    """Tile rows of equal-shaped 2-D panels, each scaled by `to_grey`, on
    a white grey-scale canvas with GAP pixels around each."""
    shape = np.shape(rows[0][0])
    out = np.full(panel_origin(len(rows), len(rows[0]), shape), 255, np.uint8)
    for r, panels in enumerate(rows):
        for c, panel in enumerate(panels):
            y, x = panel_origin(r, c, shape)
            out[y:y + shape[0], x:x + shape[1]] = to_grey(panel)
    return out
