"""Top-level model: map encoder + agent decoder (port of
infgen_tpu/model/infgen.py): the training forward and the map encoding the
rollout reads."""

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

    def forward(self, inputs, scenario_map, agent_vocab, map_vocab_traj,
                generator=None, hist_drop=None, sa_uniform=None):
        """The training forward of one scenario (the flax model's
        `__call__`): the map encoded under the masked-token visibility
        `inputs.pt_valid_mask`, then the agent decoder's forward
        (AgentDecoder.forward says which draws `generator`, `hist_drop` and
        `sa_uniform` give). Returns the decoder's dict plus
        `map_next_token_logits`."""
        x_pt = self.map_encoder(scenario_map, map_vocab_traj,
                                pt_valid_mask=inputs.pt_valid_mask,
                                generator=generator if self.training
                                else None)
        pred = self.agent_decoder(
            inputs, x_pt, agent_vocab, scenario_map.position,
            scenario_map.orientation, scenario_map.mask, generator,
            hist_drop, sa_uniform)
        pred["map_next_token_logits"] = self.map_encoder.next_token_logits(
            x_pt)
        return pred

    def encode_map(self, scenario_map, map_vocab_traj):
        """Map features x_pt [..., P, D], encoded once per scenario (leading
        dims: one map per lane)."""
        return self.map_encoder(scenario_map, map_vocab_traj)
