"""Default configuration tree.

Key set and defaults mirror the reference yacs tree exactly
(reference config/defaults.py:13-181) so that the reference's YAML
config files and ``KEY VALUE`` CLI override lists work unchanged. The JAX
package's additional keys live under the ``TPU`` section, strictly
additive.
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
    # TransReID (MODEL.NAME transformer; models/transreid.py), under its
    # own names and defaults (TransReID config/defaults.py); no ResNet
    # reads them. TRANSFORMER_TYPE names the widths, STRIDE_SIZE the
    # patch stride; SIE_CAMERA adds SIE_COE x a learned camera embedding
    # to every token; JPM runs the jigsaw branch over DEVIDE_LENGTH groups
    # of patch tokens, shifted by SHIFT_NUM and shuffled in SHUFFLE_GROUP
    # groups when RE_ARRANGE.
    _C.MODEL.TRANSFORMER_TYPE = "None"
    _C.MODEL.STRIDE_SIZE = [16, 16]
    _C.MODEL.SIE_CAMERA = False
    _C.MODEL.SIE_COE = 3.0
    _C.MODEL.JPM = False
    _C.MODEL.RE_ARRANGE = True
    _C.MODEL.SHIFT_NUM = 5
    _C.MODEL.SHUFFLE_GROUP = 2
    _C.MODEL.DEVIDE_LENGTH = 4
    # SOLIDER-REID's Swin (a swin_* TRANSFORMER_TYPE; models/swin.py):
    # lambda of its semantic controller, < 0 leaves the controller out. No
    # other model reads it.
    _C.MODEL.SEMANTIC_WEIGHT = 1.0

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
    # TransReID's test feature: the BNNecks' input ("before") or output
    # ("after"); ResNet models always embed after their BNNeck
    _C.TEST.NECK_FEAT = "after"

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
    # The JAX package's extra keys, kept under their names so that one YAML
    # or override list drives both packages. Each comment says what the
    # switch does in this port.
    _C.TPU = ConfigNode()
    # Groups the global batch is split into, each a full P x K identity
    # batch; mining, centroids and BN batch statistics are per group, and
    # the step loops over the groups (engine/steps.py). 0 means one group
    # per process of the torch.distributed group (1 without one).
    _C.TPU.NUM_GROUPS = 0
    # Keep decoded and resized images in host memory (uint8).
    _C.TPU.CACHE_IMAGES = True
    # Decode the train split once into a uint8 image bank on the card and
    # gather each step's batch there. Past DEVICE_DATA_BUDGET_MB (MB of
    # 1e6 bytes: H x W x 3 bytes an image) fit streams host batches
    # through the prefetching loader instead.
    _C.TPU.DEVICE_RESIDENT_DATA = True
    _C.TPU.DEVICE_DATA_BUDGET_MB = 4096
    # Threads that decode evaluation images.
    _C.TPU.PREFETCH_THREADS = 4
    # Host batches the streaming train loader keeps ready.
    _C.TPU.PREFETCH_DEPTH = 2
    # Rank with the hand-written selection kernels (ops/retrieval.py) when
    # a top-k is asked for; off, a stable argsort of the full distances.
    _C.TPU.USE_PALLAS_RETRIEVAL = True
    # get_similar and the HTTP front: shard the gallery over the visible
    # cards (parallel/); needs --topk and at least two cards, and gives the
    # one-card results.
    _C.TPU.SHARDED_RETRIEVAL = False
    # Write a torch.profiler trace of fit's first epoch under
    # LOG_DIR/traces.
    _C.TPU.PROFILE = False
    # Save the periodic (resume) checkpoint every N epochs. The reference
    # saves every epoch (utils/misc.py:88-93).
    _C.TPU.PERIODIC_CHECKPOINT_INTERVAL = 1
    # Graceful preemption: SIGTERM makes fit() save a ring checkpoint at
    # the next epoch boundary and exit cleanly for MODEL.RESUME_TRAINING; a
    # second SIGTERM terminates immediately. The reference has no
    # preemption handling (SURVEY.md §5).
    _C.TPU.GRACEFUL_PREEMPTION = True
    # Check every loss term and gradient of the train step and raise
    # FloatingPointError on the first that is not finite. The reference
    # has no sanitizers (SURVEY.md §5).
    _C.TPU.DEBUG_NANS = False
    # fp32 matmul and convolution precision for the run: "default" leaves
    # cuBLAS and cuDNN as they are; "highest" and "float32" turn TF32 off,
    # "tensorfloat32" on; JAX's other values raise (engine/runner.py).
    _C.TPU.MATMUL_PRECISION = "default"
    # Not read: the JAX package's space-to-depth stem computes the same
    # function as the 7x7 stride-2 conv, which the port runs as it is.
    _C.TPU.SPACE_TO_DEPTH_STEM = False
    # Fast ingest for serving and the offline inference CLIs: where the
    # native decoder builds, DCT-scaled JPEG decode and planar YUV420
    # packing (1.5 bytes a pixel to the card instead of 3), unpacked on the
    # card. Lossy (4:2:0 chroma, scaled IDCT), so off by default and never
    # used by the training or evaluation loaders.
    _C.TPU.FAST_DECODE = False
    # int8 post-training-quantized embed for ONLY_TEST and the offline
    # inference CLIs (models/quantized.py): BN and input folding,
    # per-channel int8 weights, calibrated per-tensor activation scales;
    # IBN-a's InstanceNorm half runs in the int8 domain. Evaluation during
    # training stays bf16.
    _C.TPU.INT8_EVAL = False
    # Leading batches of the input folder used for activation calibration.
    _C.TPU.INT8_CALIB_BATCHES = 4
    # Activation-range percentile for calibration; 100 = absolute max,
    # lower (e.g. 99.9) clips outliers.
    _C.TPU.INT8_CALIB_PCT = 100.0
    # Optional .npz path for the quantized model: loaded when it exists
    # and matches the run (skipping calibration), written after
    # calibration when it does not.
    _C.TPU.INT8_CACHE_PATH = ""
    # k-reciprocal re-ranking (Zhong et al., CVPR 2017) for evaluation and
    # the get_similar CLI (ops/rerank.py), absent from the reference. The
    # full re-ranker holds O(N^2) distances on the card and refuses
    # evaluation sets past ~26k rows; larger galleries take
    # RERANK_WINDOW.
    _C.TPU.RERANK = False
    _C.TPU.RERANK_K1 = 20
    _C.TPU.RERANK_K2 = 6
    _C.TPU.RERANK_LAMBDA = 0.3
    # > 0: windowed re-ranking (ops/rerank.py::rerank_topk): each query
    # re-ranks its own top RERANK_WINDOW candidates, in O(r^2) memory,
    # in get_similar, serving and evaluation (the streaming evaluator).
    _C.TPU.RERANK_WINDOW = 0

    return _C


cfg = get_default_cfg()
