"""Default configuration tree.

Key set and defaults mirror the reference yacs tree exactly
(reference config/defaults.py:13-181) so that the reference's YAML
config files and ``KEY VALUE`` CLI override lists work unchanged. Additional
TPU-specific keys live under the ``TPU`` section and are strictly additive.
"""

from .node import ConfigNode


def get_default_cfg() -> ConfigNode:
    _C = ConfigNode()

    # ------------------------------------------------------------------ MODEL
    _C.MODEL = ConfigNode()
    _C.MODEL.NAME = "resnet50"
    _C.MODEL.BACKBONE_EMB_SIZE = 2048
    _C.MODEL.LAST_STRIDE = 1
    _C.MODEL.PRETRAINED = True
    _C.MODEL.PRETRAIN_PATH = ""
    _C.MODEL.USE_CENTROIDS = False
    _C.MODEL.KEEP_CAMID_CENTROIDS = True
    _C.MODEL.RESUME_TRAINING = False

    # ------------------------------------------------------------------ INPUT
    _C.INPUT = ConfigNode()
    _C.INPUT.SIZE_TRAIN = [256, 128]
    _C.INPUT.SIZE_TEST = [256, 128]
    _C.INPUT.PROB = 0.5          # horizontal flip probability
    _C.INPUT.RE_PROB = 0.5       # random erasing probability
    _C.INPUT.PIXEL_MEAN = [0.485, 0.456, 0.406]
    _C.INPUT.PIXEL_STD = [0.229, 0.224, 0.225]
    _C.INPUT.PADDING = 10

    # --------------------------------------------------------------- DATASETS
    _C.DATASETS = ConfigNode()
    _C.DATASETS.NAMES = "market1501"
    _C.DATASETS.ROOT_DIR = "/home/data"
    _C.DATASETS.JSON_TRAIN_PATH = ""

    # ------------------------------------------------------------- DATALOADER
    _C.DATALOADER = ConfigNode()
    _C.DATALOADER.NUM_WORKERS = 6
    _C.DATALOADER.SAMPLER = "random_identity"
    _C.DATALOADER.NUM_INSTANCE = 4
    _C.DATALOADER.DROP_LAST = True
    # True for the baseline model, False for CTL (pad with masked mocks).
    _C.DATALOADER.USE_RESAMPLING = True

    # ----------------------------------------------------------------- SOLVER
    _C.SOLVER = ConfigNode()
    _C.SOLVER.OPTIMIZER_NAME = "Adam"
    _C.SOLVER.MAX_EPOCHS = 120
    _C.SOLVER.BASE_LR = 1e-4
    _C.SOLVER.MOMENTUM = 0.9
    _C.SOLVER.MARGIN = 0.5
    _C.SOLVER.DISTANCE_FUNC = "euclidean"
    _C.SOLVER.CLUSTER_MARGIN = 0.3
    _C.SOLVER.CENTER_LR = 0.5
    _C.SOLVER.CENTER_LOSS_WEIGHT = 0.0005
    _C.SOLVER.WEIGHT_DECAY = 0.0005
    _C.SOLVER.WEIGHT_DECAY_BIAS = 0.0005
    _C.SOLVER.LR_SCHEDULER_NAME = "multistep_lr"
    _C.SOLVER.MIN_LR = 0.0       # eta_min for cosine_annealing
    _C.SOLVER.GAMMA = 0.1
    _C.SOLVER.LR_STEPS = (40, 70)
    _C.SOLVER.USE_WARMUP_LR = True
    _C.SOLVER.WARMUP_EPOCHS = 10
    _C.SOLVER.MONITOR_METRIC_NAME = "mAP"
    _C.SOLVER.MONITOR_METRIC_MODE = "max"
    _C.SOLVER.CHECKPOINT_PERIOD = 50
    _C.SOLVER.EVAL_PERIOD = 5
    # NOTE: despite the name this is the number of unique pids (P) per batch,
    # the image count per step is IMS_PER_BATCH * DATALOADER.NUM_INSTANCE.
    # (reference: datasets/samplers/distributed_pids_sampler.py:27)
    _C.SOLVER.IMS_PER_BATCH = 64
    _C.SOLVER.DIST_BACKEND = "ddp"  # accepted for compat; mesh DP is used
    _C.SOLVER.QUERY_XENT_WEIGHT = 1.0
    _C.SOLVER.QUERY_CONTRASTIVE_WEIGHT = 1.0
    _C.SOLVER.CENTROID_CONTRASTIVE_WEIGHT = 1.0
    _C.SOLVER.USE_AUTOMATIC_OPTIM = False

    # ------------------------------------------------------------------- TEST
    _C.TEST = ConfigNode()
    _C.TEST.IMS_PER_BATCH = 128
    _C.TEST.WEIGHT = ""
    _C.TEST.FEAT_NORM = True
    _C.TEST.ONLY_TEST = False
    _C.TEST.VISUALIZE = "no"
    _C.TEST.VISUALIZE_TOPK = 10
    _C.TEST.VISUALIZE_MAX_NUMBER = 1000000

    # ------------------------------------------------------------------- MISC
    _C.GPU_IDS = [0]             # accepted for compat; TPU devices are used
    _C.LOG_DIR = "logs"
    _C.USE_MIXED_PRECISION = True   # bf16 compute on TPU
    _C.OUTPUT_DIR = ""

    # -------------------------------------------------------- REPRODUCIBILITY
    _C.REPRODUCIBLE = False
    _C.REPRODUCIBLE_NUM_RUNS = 3
    _C.REPRODUCIBLE_SEED = 0

    # ----------------------------------------------------------- TPU-SPECIFIC
    _C.TPU = ConfigNode()
    # Number of data-parallel groups the global batch is split into. Each
    # group holds a full P x K identity batch; hard-example mining is local
    # to a group (matches per-rank DDP semantics of the reference). 0 means
    # "use jax.device_count()".
    _C.TPU.NUM_GROUPS = 0
    # Cache decoded+resized train images in host RAM (uint8).
    _C.TPU.CACHE_IMAGES = True
    # Keep the decoded train set resident in HBM and run each epoch as one
    # scanned XLA program (zero per-step host work). Falls back to streaming
    # when the image bank exceeds the budget. Multi-host: each host decodes
    # the full bank and replicates it; the epoch scan is one global SPMD
    # program over the data mesh.
    _C.TPU.DEVICE_RESIDENT_DATA = True
    _C.TPU.DEVICE_DATA_BUDGET_MB = 4096
    # Number of host prefetch threads for image decoding.
    _C.TPU.PREFETCH_THREADS = 4
    # Batches to keep in flight on device.
    _C.TPU.PREFETCH_DEPTH = 2
    # Use the Pallas fused distance+top-k kernel for retrieval when possible.
    _C.TPU.USE_PALLAS_RETRIEVAL = True
    # get_similar CLI: shard the gallery over all local devices
    # (parallel.sharded_topk) — for galleries past one chip's HBM on
    # multi-chip hosts. Requires --topk (full-distmat output cannot
    # shard) and >= 2 devices; identical results to the single-chip path.
    _C.TPU.SHARDED_RETRIEVAL = False
    # Emit jax.profiler traces into LOG_DIR/traces when set.
    _C.TPU.PROFILE = False
    # Save the periodic (crash-resume) checkpoint every N epochs. The
    # reference hardcodes every epoch (utils/misc.py:88-93); pulling the
    # full train state off-device each epoch is expensive on TPU.
    _C.TPU.PERIODIC_CHECKPOINT_INTERVAL = 1
    # Graceful preemption: SIGTERM (spot/maintenance notice) makes fit()
    # save a ring checkpoint at the next epoch boundary and exit cleanly
    # for MODEL.RESUME_TRAINING; a second SIGTERM terminates immediately.
    # The reference has no preemption handling (SURVEY.md §5).
    _C.TPU.GRACEFUL_PREEMPTION = True
    # Debug aid: abort on the first NaN/Inf produced on device
    # (jax_debug_nans). The reference has no sanitizers (SURVEY.md §5).
    _C.TPU.DEBUG_NANS = False
    # Matmul/conv precision for fp32 runs (jax_default_matmul_precision).
    # IMPORTANT: XLA's TPU default lowers fp32 convolutions to single-pass
    # bf16 MXU operands (verified by HLO inspection — see README
    # "Performance notes"), so USE_MIXED_PRECISION False buys fp32
    # *activation storage and BN/loss math*, not fp32 conv arithmetic.
    # "high" (bf16_3x, ~1.4x step time) or "highest" (fp32-exact, ~2.1x)
    # opt into more conv precision.
    _C.TPU.MATMUL_PRECISION = "default"
    # Compute the 7x7/s2 stem conv as a 4x4/s1 conv over space-to-depth(2)
    # input (MLPerf-style), sharing the reference (7,7,3,64) kernel — exact
    # numerics, checkpoint-compatible. MEASURED A WASH on v5e (eval 13.1k
    # vs 13.5k imgs/s, train step +-0.4%): current XLA already lays out the
    # 3-channel stem well, so this classic lever is OFF by default and kept
    # as a knob for other TPU generations.
    _C.TPU.SPACE_TO_DEPTH_STEM = False
    # Serving-path fast ingest for the offline inference CLIs: DCT-scaled
    # JPEG decode (libjpeg scale_num/8, large sources only pay ~1/k^2 of
    # the IDCT) + planar YUV420 packing — 1.5 bytes/px on the host->device
    # wire instead of 3, unpacked (triangle chroma upsample + BT.601)
    # inside the jitted embed program. NOT bit-exact vs the parity decode
    # path (scaled IDCT + 4:2:0 chroma are lossy; embedding agreement is
    # asserted in tests/test_fast_ingest.py), so this is OFF by default
    # and never applies to training/eval loaders.
    _C.TPU.FAST_DECODE = False
    # int8 post-training-quantized serving for the offline inference CLIs
    # (models/quantized.py): BN+input folding, per-channel int8 weights,
    # self-calibrated per-tensor activation scales. Measured 1.66x embedding
    # throughput on v5e vs bf16 (plain ResNets; IBN-a supported too — its
    # per-sample IN halves run in the int8 domain after a round-3
    # measurement showed the old fp32 materialisation was the entire IBN
    # slowdown, benchmarks/bench_int8_ibn.py). Eval during *training*
    # stays bf16.
    _C.TPU.INT8_EVAL = False
    # Leading batches of the input folder used for activation calibration.
    _C.TPU.INT8_CALIB_BATCHES = 4
    # Activation-range percentile for calibration; 100 = absolute max,
    # lower (e.g. 99.9) clips outliers — more robust on trained
    # checkpoints with heavy-tailed activations.
    _C.TPU.INT8_CALIB_PCT = 100.0
    # Optional .npz path for the quantized model: loaded when it exists
    # (skipping calibration entirely), written after calibration when it
    # does not — one validated artifact serves every later run.
    _C.TPU.INT8_CACHE_PATH = ""
    # k-reciprocal re-ranking (Zhong et al., CVPR 2017) for evaluation and
    # the get_similar CLI — the reid ecosystem's standard post-hoc accuracy
    # booster, absent from the reference (SURVEY.md has no rerank
    # component); TPU-native implementation in ops/rerank.py. O(N^2) HBM:
    # refuse eval sets past ~26k rows (Market/Duke fit; fashion-scale
    # galleries should keep the streaming evaluator instead).
    _C.TPU.RERANK = False
    _C.TPU.RERANK_K1 = 20
    _C.TPU.RERANK_K2 = 6
    _C.TPU.RERANK_LAMBDA = 0.3
    # > 0 switches get_similar's re-ranking to the windowed variant
    # (ops/rerank.py::rerank_topk): retrieve this many candidates per
    # query with the fused top-k kernel, re-rank each query against its
    # own candidate set. O(r^2) transient memory instead of O((Q+G)^2)
    # resident — the production form for galleries past the full
    # re-ranker's ~26k-row guard. Only meaningful with --topk; full-matrix
    # requests (--topk 0) and evaluation keep the exact full re-ranker.
    _C.TPU.RERANK_WINDOW = 0

    return _C


cfg = get_default_cfg()
