"""Framework-wide enums of the PyTorch/CUDA port.

Counterpart of ``flexflow_tpu/ffconst.py``: the same names (the reference
FlexFlow vocabulary) so that code moves between the two packages by
changing the import. ``DataType.to_torch`` replaces ``to_jnp``.
"""

import enum

import torch


class DataType(enum.Enum):
    DT_BOOLEAN = "bool"
    DT_INT32 = "int32"
    DT_INT64 = "int64"
    DT_HALF = "float16"
    DT_BFLOAT16 = "bfloat16"
    DT_FLOAT = "float32"
    DT_DOUBLE = "float64"
    DT_INT4 = "int4"
    DT_INT8 = "int8"
    DT_NONE = "none"

    def to_torch(self) -> torch.dtype:
        if self == DataType.DT_NONE:
            raise ValueError("DT_NONE has no torch dtype")
        if self == DataType.DT_INT4:
            # torch has no 4-bit tensor dtype: int4 weights exist only as
            # the packed payload of a quant.QuantizedWeight (two rows a
            # byte, int8 storage)
            raise ValueError("DT_INT4 has no torch dtype: int4 weights are "
                             "stored as a packed quant.QuantizedWeight "
                             "(FFConfig(quantization_type='int4'))")
        return _DT_TO_TORCH[self.value]

    @staticmethod
    def from_torch(dtype: torch.dtype) -> "DataType":
        return _TORCH_TO_DT[dtype]


_DT_TO_TORCH = {
    "bool": torch.bool,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "int8": torch.int8,
}
_TORCH_TO_DT = {v: DataType(k) for k, v in _DT_TO_TORCH.items()}


def torch_dtype(name) -> torch.dtype:
    """A dtype name as FFConfig spells it ("bfloat16") -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return _DT_TO_TORCH[str(name)]


class ActiMode(enum.Enum):
    AC_MODE_NONE = 10
    AC_MODE_RELU = 11
    AC_MODE_SIGMOID = 12
    AC_MODE_TANH = 13
    AC_MODE_GELU = 14


class AggrMode(enum.Enum):
    AGGR_MODE_NONE = 20
    AGGR_MODE_SUM = 21
    AGGR_MODE_AVG = 22


class PoolType(enum.Enum):
    POOL_MAX = 30
    POOL_AVG = 31


class LossType(enum.Enum):
    LOSS_CATEGORICAL_CROSSENTROPY = 50
    LOSS_SPARSE_CATEGORICAL_CROSSENTROPY = 51
    LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE = 52
    LOSS_MEAN_SQUARED_ERROR_SUM_REDUCE = 53
    LOSS_IDENTITY = 54


class MetricsType(enum.Enum):
    METRICS_ACCURACY = 1001
    METRICS_CATEGORICAL_CROSSENTROPY = 1002
    METRICS_SPARSE_CATEGORICAL_CROSSENTROPY = 1004
    METRICS_MEAN_SQUARED_ERROR = 1008
    METRICS_ROOT_MEAN_SQUARED_ERROR = 1016
    METRICS_MEAN_ABSOLUTE_ERROR = 1032


class CompMode(enum.Enum):
    COMP_MODE_TRAINING = 70
    COMP_MODE_INFERENCE = 71


class ParameterSyncType(enum.Enum):
    """The reference's gradient-sync vocabulary (the JAX package's name
    set; on one device there is nothing to sync)."""

    NONE = 80
    PS = 81
    NCCL = 82


class RequestType(enum.Enum):
    REQ_INFERENCE = 4001
    REQ_FINETUNING = 4002


class InferenceMode(enum.Enum):
    INC_DECODING_MODE = 2001
    BEAM_SEARCH_MODE = 2002
    TREE_VERIFY_MODE = 2003


class OpType(enum.Enum):
    """Operator types: the members of ``flexflow_tpu.ffconst.OpType`` that
    the port implements (each later slice adds the ones it ports)."""

    # graph bookkeeping: the no-op and input nodes, and the reference's
    # fused-op nodes (never built here: kernels are fused by hand)
    NOOP = enum.auto()
    INPUT = enum.auto()
    FUSED = enum.auto()
    FUSED_PARALLEL = enum.auto()
    EMBEDDING = enum.auto()
    CONV2D = enum.auto()
    POOL2D = enum.auto()
    BATCHNORM = enum.auto()
    DROPOUT = enum.auto()
    MULTIHEAD_ATTENTION = enum.auto()
    SOFTMAX = enum.auto()
    LAYERNORM = enum.auto()
    RESIDUAL_LAYERNORM = enum.auto()
    ADD_BIAS_RESIDUAL_LAYERNORM = enum.auto()
    RMS_NORM = enum.auto()
    RESIDUAL_RMS_NORM = enum.auto()
    SIGMOID_SILU_MULTI = enum.auto()
    LINEAR = enum.auto()
    # elementwise binary
    EW_ADD = enum.auto()
    EW_SUB = enum.auto()
    EW_MUL = enum.auto()
    EW_DIV = enum.auto()
    EW_MAX = enum.auto()
    EW_MIN = enum.auto()
    # elementwise unary
    RELU = enum.auto()
    GELU = enum.auto()
    SIGMOID = enum.auto()
    TANH = enum.auto()
    ELU = enum.auto()
    EXP = enum.auto()
    SIN = enum.auto()
    COS = enum.auto()
    RSQRT = enum.auto()
    IDENTITY = enum.auto()
    POW = enum.auto()
    # elementwise with a scalar
    SCALAR_MULTIPLY = enum.auto()
    SCALAR_ADD = enum.auto()
    SCALAR_SUB = enum.auto()
    SCALAR_TRUE_DIV = enum.auto()
    INC_MULTIHEAD_SELF_ATTENTION = enum.auto()
    SPEC_INC_MULTIHEAD_SELF_ATTENTION = enum.auto()
    TREE_INC_MULTIHEAD_SELF_ATTENTION = enum.auto()
    CONCAT = enum.auto()
    SPLIT = enum.auto()
    RESHAPE = enum.auto()
    SLICE = enum.auto()
    TRANSPOSE = enum.auto()
    REVERSE = enum.auto()
    FLAT = enum.auto()
    CAST = enum.auto()
    REDUCE_SUM = enum.auto()
    REDUCE_MEAN = enum.auto()
    MEAN = enum.auto()
    GATHER = enum.auto()
    TOPK = enum.auto()
    ARG_TOPK = enum.auto()
    ARGMAX = enum.auto()
    SAMPLING = enum.auto()
    BEAM_TOPK = enum.auto()
    # constants / selection and the free-standing parameter
    WEIGHT = enum.auto()
    CONSTANT = enum.auto()
    WHERE = enum.auto()
    COMPARE = enum.auto()
    BROADCAST_TO = enum.auto()
    BATCH_MATMUL = enum.auto()
    # MoE and the cross-batch cache
    GROUP_BY = enum.auto()
    AGGREGATE = enum.auto()
    AGG_SPEC = enum.auto()
    EXPERTS = enum.auto()
    CACHE = enum.auto()
    # parallel ops (PCG nodes in the reference; collectives over the mesh)
    REPARTITION = enum.auto()
    COMBINE = enum.auto()
    REPLICATE = enum.auto()
    REDUCTION = enum.auto()
    ALLREDUCE = enum.auto()
