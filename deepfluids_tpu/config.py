"""Config system — grouped flags with the reference's names.

Reference: deep-fluids ``config.py`` (SURVEY.md §2 "Config system", §5
"Config / flag system" [M]): argparse in groups (network / data / train /
test), every hyperparameter a flag, config persisted as JSON in the run dir.
Flag names are kept identical where the reference had them (``--arch``,
``--is_train``, ``--dataset``, ``--data_type``, ``--res_x/y/z``, ``--is_3d``,
``--w1/--w2``, ``--use_curl``, ``--lr_max/--lr_min``, ``--max_step``,
``--batch_size``, ``--load_path``, ``--tag``) so reference commands translate
1:1 (SURVEY §5).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Optional


def _str2bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    low = v.lower()
    if low in ("yes", "true", "t", "1"):
        return True
    if low in ("no", "false", "f", "0"):
        return False
    # A typo like --is_train=Ture must fail loudly, not silently mean False.
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


@dataclasses.dataclass
class Config:
    # --- network ---
    arch: str = "de"           # de | ae | nn
    filters: int = 128
    num_conv: int = 4
    repeat: int = 0            # 0 -> derived from resolution
    z_num: int = 16            # latent size (ae/nn)
    use_curl: bool = True
    w1: float = 1.0            # field L1 weight
    w2: float = 1.0            # jacobian L1 weight
    w3: float = 1.0            # latent param-supervision weight (ae)
    ae_pred_w: float = 0.0     # >0 (ae): PREDICTION-AWARE AE — batches
                               # become (t, t+1) frame pairs and a
                               # co-trained one-step latent predictor adds
                               # w * mse(z_t_free + P([z_t;dp]), z_{t+1,free})
                               # so the ENCODER is optimized to emit codes
                               # whose dynamics are Markovian.  Mechanism:
                               # the r5 probe (BENCHMARKS.md) showed a
                               # recon-only AE discards per-frame state the
                               # latent dynamics need (mov one-step holdout
                               # R2 0.26), capping every downstream
                               # integrator; the field itself is Markovian
                               # given params, so z can be made so.
    ae_pred_hidden: int = 512  # width of the co-trained predictor MLP
    relative_loss: bool = False  # weight samples by 1/mean|x| (optimizes
                                 # the per-frame normalized-L2 metric)
    loss_norm: str = "l1"      # per-element distance of the field/jacobian
                               # loss terms: "l1" (reference) | "l2"
    embed_bands: int = 0       # >0: Fourier-embed the generator's param
                               # vector (sin/cos(2^k pi p), k<bands) — more
                               # high-frequency capacity along the frame
                               # axis; 0 = reference-parity (arch de only)
    spectral_modes: int = 0    # >0: zero-init learned global Fourier
                               # filter (channel-diagonal FNO core) after
                               # each generator stage; 0 = reference-parity
                               # (arch de only)
    decoder: str = "be"        # generator decoder family (arch de):
                               # "be" = reference BEGAN-style conv pyramid;
                               # "grid" = beyond-reference multi-resolution
                               # feature-grid decoder (param-space feature
                               # grids + per-stage low-rank spatial basis
                               # injection) — targets the ~0.215 overfit
                               # floor the BE family plateaus at
                               # (BENCHMARKS.md "quality plateau, diagnosed")
    grid_levels: int = 4       # decoder=grid: multi-res param-grid levels
    grid_features: int = 4     # decoder=grid: features per grid cell
    grid_rank: int = 8         # decoder=grid: spatial basis rank per stage
    # nn (latent integrator)
    nn_hidden: int = 512
    nn_depth: int = 2
    w_num: int = 30            # rollout window length [B]
    remat_rollout: bool = False  # jax.checkpoint each rollout step (O(1)
                                 # activation memory for long windows)
    nn_noise: float = 0.0      # rollout-training noise std injected into
                               # the integrated latent block each window
                               # step — trains the integrator to contract
                               # its own prediction errors (long-horizon
                               # drift stabilizer; 0 = reference parity)
    nn_field_w: float = 0.0    # >0: add w * field_loss(decode(z_pred),
                               # decode(z_true)) through the FROZEN AE
                               # decoder (--ae_load_path) on a subsample of
                               # window steps — optimizes the integrator in
                               # the metric that matters (decoded field
                               # drift), not just latent MSE; latent dims
                               # get reweighted by the decoder's jacobian
                               # (r4 VERDICT #2 mechanism attack)
    nn_field_frames: int = 4   # window positions decoded per step for
                               # --nn_field_w (cost control: decodes
                               # nn_field_frames x batch fields per step)
    nn_history: int = 1        # integrator order: H>1 feeds the MLP the
                               # last H latent codes [z_t;..;z_{t-H+1};dp]
                               # and seeds rollouts with H true codes.
                               # The r5 predictability probe shows mov's
                               # latent dynamics are non-Markovian in z
                               # (holdout R² 0.26 @ H=1 → 0.86 @ H=4);
                               # 1 = reference parity (SURVEY §3.4 MLP)

    # --- data ---
    data_dir: str = "data"
    dataset: str = "smoke_pos21_size5"
    data_type: str = "velocity"   # velocity | levelset
    batch_size: int = 8
    num_worker: int = 8
    cache_data: bool = True
    input_pipeline: str = "native"  # "native" (BatchManager + C++ npz
                                    # reader; default) | "grain" (grain
                                    # DataLoader: worker-process prefetch +
                                    # per-host sharding for multi-host runs)
    eval_holdout_scenes: int = 0    # >0: exclude N scenes from training;
                                    # Trainer.evaluate() samples ONLY those
                                    # scenes (a real held-out quality number)
    holdout_mode: str = "edge"      # which N scenes --eval_holdout_scenes
                                    # excludes: "edge" = lexically-last
                                    # (param-box edge -> measures
                                    # EXTRAPOLATION) | "interior" =
                                    # stratified inner grid scenes
                                    # (measures INTERPOLATION, the sweep
                                    # use case; data.dataset.
                                    # select_holdout_keys)
    code_suffix: str = ""           # latent-code set name suffix: the AE
                                    # encode pass writes (and arch nn
                                    # reads) <dataset>/code<z_num><suffix>
                                    # — lets codes from different AEs of
                                    # the same z_num coexist
    augment_flip_x: bool = False    # mirror a random half of each train
                                    # batch across x (u negated; *_x_pos
                                    # params reflected) — every scene
                                    # family here is x-symmetric, so this
                                    # doubles effective scene variety for
                                    # free (de/ae; beyond-reference).
                                    # Exact-resume safe: the flip mask is
                                    # a pure fn of (seed, step).

    # --- dims (0 -> read from manifest) ---
    is_3d: bool = False
    res_x: int = 0
    res_y: int = 0
    res_z: int = 0

    # --- train ---
    is_train: bool = True
    max_step: int = 100_000
    lr_max: float = 1e-4
    lr_min: float = 2.5e-6
    beta1: float = 0.5
    beta2: float = 0.999
    grad_clip: float = 0.0     # >0: global-norm gradient clipping
    seed: int = 123
    log_step: int = 100
    test_step: int = 1000
    save_step: int = 5000
    compute_dtype: str = "bfloat16"   # conv/dense compute dtype
    num_data_shards: int = 0          # 0 -> all devices on the data mesh axis
    num_model_shards: int = 1         # tensor-parallel axis: conv/dense
                                      # output channels sharded over it
                                      # (weights + Adam state; XLA inserts
                                      # the activation collectives)
    steps_per_call: int = 1           # train steps fused into one device
                                      # program (lax.scan over prefetched
                                      # batches; amortizes dispatch latency)
    device_data_cache: bool = False   # stage the whole normalized dataset
                                      # in HBM once and gather batches by
                                      # index on device (zero host->device
                                      # bytes per step; de/ae only)
    cache_dtype: str = "float32"      # device_data_cache storage dtype;
                                      # "float16" halves HBM for big 3D
                                      # datasets (fields are in [-1,1];
                                      # gathered batches are cast back to
                                      # f32 before the loss)
    spatial_shard: bool = False       # shard the grid's H (2D) / D (3D)
                                      # axis over the data mesh axis instead
                                      # of the batch: halo-exchange loss
                                      # stencils + GSPMD-partitioned convs
                                      # (for grids too large per chip;
                                      # de/ae only)

    # --- test / inference ---
    load_path: str = ""
    ae_load_path: str = ""     # AE run dir for arch=nn rollout decoding
    test_batch_size: int = 32
    test_frames: int = 0       # 0 -> manifest num_frames
    test_counts: str = ""      # sweep grid per non-frame param, e.g. "21,5";
                               # "" -> the dataset's own generation grid
                               # (manifest param_counts), like the reference

    watchdog_secs: float = 0.0        # >0: abort (exit 17) if a train-loop
                                      # device call completes no progress
                                      # for this long — hang detection;
                                      # pair with
                                      # tools/supervise.py, which relaunches
                                      # with --load_path (resume is exact).
                                      # Set above the worst-case compile
                                      # time of the first 3D backward.
    die_at_step: int = 0              # >0: fault injection — abort (exit
                                      # 17, no checkpoint) when training
                                      # crosses this step, ONCE per run dir
                                      # (a .fault_injected sentinel disarms
                                      # it so a supervised relaunch
                                      # completes).  Tests the supervisor's
                                      # kill/resume path (SURVEY §5).

    # --- observability / debugging (SURVEY.md §5 aux subsystems) ---
    use_tensorboard: bool = False   # tensorboardX scalars beside metrics.jsonl
    profile_steps: str = ""         # "start,stop" step range to trace
    profile_dir: str = ""           # trace output (default <run>/profile)
    debug_nans: bool = False        # jax_debug_nans for fault isolation

    # --- bookkeeping ---
    log_dir: str = "logs"
    tag: str = "tag"

    @property
    def dataset_dir(self) -> str:
        return os.path.join(self.data_dir, self.dataset)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("deepfluids_tpu")
    defaults = Config()
    groups = {
        "network": ["arch", "filters", "num_conv", "repeat", "z_num",
                    "use_curl", "w1", "w2", "w3", "relative_loss",
                    "loss_norm", "embed_bands", "spectral_modes",
                    "decoder", "grid_levels", "grid_features", "grid_rank",
                    "nn_hidden", "nn_depth",
                    "w_num", "remat_rollout", "nn_noise",
                    "nn_field_w", "nn_field_frames", "nn_history",
                    "ae_pred_w", "ae_pred_hidden"],
        "data": ["data_dir", "dataset", "data_type", "batch_size",
                 "num_worker", "cache_data", "input_pipeline",
                 "eval_holdout_scenes", "holdout_mode", "code_suffix",
                 "augment_flip_x", "is_3d", "res_x", "res_y", "res_z"],
        "train": ["is_train", "max_step", "lr_max", "lr_min", "beta1",
                  "beta2", "grad_clip", "seed", "log_step", "test_step",
                  "save_step",
                  "compute_dtype", "num_data_shards", "num_model_shards",
                  "steps_per_call", "device_data_cache", "cache_dtype",
                  "spatial_shard", "watchdog_secs", "die_at_step"],
        "test": ["load_path", "ae_load_path", "test_batch_size",
                 "test_frames", "test_counts"],
        "misc": ["log_dir", "tag", "use_tensorboard", "profile_steps",
                 "profile_dir", "debug_nans"],
    }
    # Categorical flags get explicit choices so a typo like --loss_norm=L1
    # or --arch=DE fails at parse time instead of silently selecting a
    # default branch downstream (same failure class _str2bool guards).
    choices = {
        "arch": ("de", "ae", "nn"),
        "data_type": ("velocity", "levelset"),
        "loss_norm": ("l1", "l2"),
        "compute_dtype": ("bfloat16", "float32"),
        "cache_dtype": ("float32", "float16"),
        "input_pipeline": ("native", "grain"),
        "decoder": ("be", "grid"),
        "holdout_mode": ("edge", "interior"),
    }
    for gname, names in groups.items():
        g = p.add_argument_group(gname)
        for n in names:
            default = getattr(defaults, n)
            t = type(default)
            if t is bool:
                g.add_argument(f"--{n}", type=_str2bool, default=default)
            else:
                g.add_argument(f"--{n}", type=t, default=default,
                               choices=choices.get(n))
    return p


def get_config(argv: Optional[list[str]] = None) -> Config:
    ns = get_parser().parse_args(argv)
    cfg = Config(**vars(ns))
    # Record which flags were EXPLICITLY given (parse again with every
    # default suppressed — argparse then only sets attributes it saw).
    # merge_test_config needs this to honor an override whose value
    # happens to equal the dataclass default (e.g. turning a saved
    # --num_model_shards 2 back down to the default 1 at test time).
    sup = get_parser()
    for a in sup._actions:
        a.default = argparse.SUPPRESS
    cfg._explicit_flags = frozenset(vars(sup.parse_args(argv)))
    return cfg


def save_config(config: Config, run_dir: str) -> str:
    """Persist the config as JSON beside the checkpoints (reference
    util.save_config, SURVEY.md §2 [M])."""
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, "params.json")
    with open(path, "w") as f:
        f.write(config.to_json())
    return path


def load_config(run_dir: str) -> Config:
    with open(os.path.join(run_dir, "params.json")) as f:
        d = json.load(f)
    known = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in d.items() if k in known})


def merge_test_config(cli: Config, run_dir: str) -> Config:
    """Test-time config: the RUN'S OWN saved flags, with explicit CLI
    overrides on top.

    A test/sweep invocation must rebuild the architecture that was
    TRAINED, not whatever the current command line defaults to — a sweep
    launched with bare ``--is_train false --load_path <run>`` on a run
    with non-default ``--filters``/``--decoder`` would otherwise build a
    mismatched model and fail checkpoint restore.  Flags that
    were EXPLICITLY passed on the command line win (get_config records
    them in ``_explicit_flags``, so an override whose value equals the
    dataclass default — e.g. ``--num_model_shards 1`` on a TP-trained
    run — still applies); for Configs built directly in code the
    fallback is the value-differs-from-default heuristic.  Everything
    else comes from the run's params.json.  Returns ``cli`` unchanged if
    the run dir has no params.json.
    """
    try:
        saved = load_config(run_dir)
    except FileNotFoundError:
        return cli
    explicit = getattr(cli, "_explicit_flags", None)
    default = Config()
    for f in dataclasses.fields(Config):
        v = getattr(cli, f.name)
        if (f.name in explicit if explicit is not None
                else v != getattr(default, f.name)):
            setattr(saved, f.name, v)
    saved.is_train = cli.is_train
    saved.load_path = cli.load_path
    return saved
