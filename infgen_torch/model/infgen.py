"""Top-level model: map encoder + agent decoder (port of
infgen_tpu/model/infgen.py)."""

from torch import nn

from infgen_torch.config import Config
from infgen_torch.model.agent_decoder import AgentDecoder
from infgen_torch.model.map_encoder import MapEncoder


class InfGenModel(nn.Module):
    def __init__(self, cfg: Config, grid_xy, grid_size: int, angle_size: int):
        super().__init__()
        self.cfg = cfg
        self.map_encoder = MapEncoder(cfg)
        self.agent_decoder = AgentDecoder(cfg, grid_xy, grid_size, angle_size)

    def encode_map(self, scenario_map, map_vocab_traj):
        """Map features x_pt [..., P, D], encoded once per scenario (leading
        dims: one map per lane)."""
        return self.map_encoder(scenario_map, map_vocab_traj)
