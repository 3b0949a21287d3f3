"""The tiny stand-ins of the benchmark's cells that the CPU tests run,
with the tight limits an f32 run of the program meets against the f32
reference (each gap is f32 rounding, under 1e-5 at this size)."""
from bench.tests import tiny

STEP = ("tiny-step", "zamba2-pfels-step",
        {"driver": "production_step", "batch": 2, "seq": 32,
         "setup_steps": 3, "traced_units": 1},
        {"loss_gap": 1e-5, "grad_norm_gap": 1e-5, "beta_gap": 1e-5,
         "energy_gap": 1e-5, "change_gap": 1e-5})
PREFILL = ("tiny-prefill", "zamba2-prefill",
           {"driver": "prefill", "batch": 4, "prompt": 64, "check_rows": 3,
            "cache_rows": 2, "traced_units": 1},
           {"logit_gap": 1e-4, "logits_err": 1e-5, "cache_err": 1e-5})
CELLS = (STEP, PREFILL)


def root_with(tmp, cell, dtype="float32", limits=None):
    name, real, traffic, lim = cell
    cfg = tiny.tiny_lm_config(dtype)
    return tiny.make_root(tmp, [(name, cfg, "t_" + name, traffic,
                                 lim if limits is None else limits, real)])

TINY_CNN = {"arch": "resnet", "in_channels": 1, "image_size": 8,
            "num_classes": 10, "width_mult": 0.125, "dtype": "float32"}
ROUND = ("tiny-round", "femnist-resnet18-round",
         {"driver": "fl_round", "samples_per_client": 12,
          "dirichlet_alpha": 0.5, "image_noise": 0.5, "setup_rounds": 2,
          "traced_units": 1},
         {"first_loss_gap": 1e-5, "loss_gap": 1e-5, "update_norm_gap": 1e-5,
          "beta_gap": 1e-5, "energy_gap": 1e-5, "change_gap": 1e-5})


def round_root(tmp, limits=None):
    import json
    cfg = json.loads((tiny.REPO / "bench/configs/femnist-resnet18.json")
                     .read_text())
    cfg["name"] = "tiny-cnn"
    cfg["model"] = dict(TINY_CNN)
    cfg["pfels"].update(num_clients=20, clients_per_round=4, local_steps=2,
                        use_fused_kernel=False)
    name, real, traffic, lim = ROUND
    return tiny.make_root(tmp, [(name, cfg, "t_" + name, traffic,
                                 lim if limits is None else limits, real)])


CELLS_ALL = CELLS + (ROUND,)


def root_of(tmp, cell, dtype="float32"):
    """The tiny root of any of the cells above."""
    return round_root(tmp) if cell is ROUND else root_with(tmp, cell, dtype)
