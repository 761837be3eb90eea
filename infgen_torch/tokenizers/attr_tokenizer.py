"""Ego-relative grid / heading tokenizer (port of
infgen_tpu/tokenizers/attr_tokenizer.py).

A square grid of pitch `grid_interval` over [-grid_range/2, grid_range/2]^2,
masked to the disc of radius `radius` (= pl2seed_radius), classifies
ego-relative insert positions; headings are binned at `angle_interval`
degrees. The grid is built host-side in numpy; encode/decode run on tensors.
"""

import math

import numpy as np
import torch

from infgen_torch.utils.geometry import rot_mat_2d, wrap_angle


class AttrTokenizer:
    # the grid is aligned to a canonical heading of +pi/2: encoded positions
    # are rotated so that ego faces "up"
    HEADING = math.pi / 2

    def __init__(self, grid_range: float = 150.0, grid_interval: float = 3.0,
                 radius: float = 75.0, angle_interval: float = 3.0):
        self.grid_range = grid_range
        self.grid_interval = grid_interval
        self.radius = radius
        self.angle_interval = angle_interval

        num_grid = int(grid_range / grid_interval) + 1
        x = np.arange(num_grid, dtype=np.float32)
        gx, gy = np.meshgrid(x, x, indexing="xy")
        grid = np.stack([gx.ravel(), gy.ravel()], axis=-1)
        grid = grid.reshape(num_grid, num_grid, 2)[::-1].reshape(-1, 2)
        grid = (grid - num_grid // 2) * grid_interval

        dist = np.sqrt((grid ** 2).sum(-1))
        square_mask = (dist <= radius) | (dist == 0.0)
        self.num_grid = num_grid
        self.square_mask = square_mask
        self.grid = grid[square_mask].astype(np.float32)  # [grid_size, 2]
        self.grid_size = int(self.grid.shape[0])
        self.angle_size = int(360.0 / angle_interval)
        self._grid_t = {}
        assert bool(np.all(self.grid[self.grid_size // 2] == 0.0))

    def grid_on(self, device) -> torch.Tensor:
        """The [grid_size, 2] grid as a tensor on `device` (cached; while a
        program is traced, torch.export, a fresh one that is not kept)."""
        key = str(device)
        if key not in self._grid_t:
            grid = torch.as_tensor(self.grid, device=device)
            if torch.compiler.is_compiling():
                return grid
            self._grid_t[key] = grid
        return self._grid_t[key]

    def encode_pos(self, x, y, theta_y=None):
        """Grid-cell index + xy offset of world positions `x` relative to
        ego `y`. x [..., 2]; y broadcastable [..., 2]; theta_y
        broadcastable [...]. Returns (index [...] int64, offset [..., 2])."""
        grid = self.grid_on(x.device)
        centered = x - y
        if theta_y is not None:
            rot = rot_mat_2d(-(theta_y - self.HEADING))
            centered = torch.einsum("...i,...ij->...j", centered, rot)
        d2 = ((centered[..., None, :] - grid) ** 2).sum(-1)
        index = torch.argmin(d2, dim=-1)
        return index, centered - grid[index]

    def encode_heading(self, heading):
        """Heading bin index."""
        deg = (wrap_angle(heading) + math.pi) / (2 * math.pi) * 360.0
        return torch.div(deg, self.angle_interval,
                         rounding_mode="floor").to(torch.int32)
