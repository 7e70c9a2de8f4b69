"""The paper's contribution, Δ-SGD client-adaptive federated optimization,
plus every optimizer and loss it is compared against, on the vmap and
the flat engines."""
from repro_torch.core import flat
from repro_torch.core.client_opt import CLIENT_OPTS, ClientOpt, get_client_opt
from repro_torch.core.delta_sgd import (DeltaSGDState, FlatDeltaSGDState,
                                        delta_sgd_init, delta_sgd_reset,
                                        delta_sgd_update, flat_delta_sgd_init,
                                        flat_delta_sgd_step)
from repro_torch.core.fed_loop import (FlatFLState, arena_gather,
                                       flatten_fl_state, make_fl_loop,
                                       make_fleet_loop, unflatten_fl_state)
from repro_torch.core.fed_round import (FLState, RoundAux, init_fl_state,
                                        make_fl_round)
from repro_torch.core.losses import make_loss
from repro_torch.core.server_opt import SERVER_OPTS, ServerOpt, get_server_opt

__all__ = ["CLIENT_OPTS", "ClientOpt", "get_client_opt", "DeltaSGDState",
           "FlatDeltaSGDState", "delta_sgd_init", "delta_sgd_reset",
           "delta_sgd_update", "flat_delta_sgd_init", "flat_delta_sgd_step",
           "FLState", "RoundAux", "init_fl_state", "make_fl_round",
           "make_loss", "FlatFLState", "arena_gather", "flatten_fl_state",
           "make_fl_loop", "make_fleet_loop", "unflatten_fl_state",
           "SERVER_OPTS", "ServerOpt", "get_server_opt", "flat"]
