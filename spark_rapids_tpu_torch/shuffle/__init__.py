"""The host shuffle (counterpart of ``spark_rapids_tpu/shuffle/``): the
block transport, the serializer, the manager, the engine's exchange
across worker processes (``stage.py``) and ``distributed_groupby``
(``worker.py``)."""

from spark_rapids_tpu_torch.shuffle.transport import (  # noqa: F401
    ShuffleClient, ShuffleServer, native_available,
)
from spark_rapids_tpu_torch.shuffle.serializer import (  # noqa: F401
    BlockCorruptError, ChecksumUnavailableError, CodecUnavailableError,
    FrameUnavailableError, HostBlock, deserialize_blocks, serialize_block,
)
from spark_rapids_tpu_torch.shuffle.manager import (  # noqa: F401
    FetchFailedError, TorchShuffleManager,
)
