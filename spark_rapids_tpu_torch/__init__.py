"""spark_rapids_tpu_torch: the PyTorch / CUDA port of spark_rapids_tpu.

It runs the engine on an NVIDIA H100: plain tensor code is PyTorch, and
each kernel the JAX package wrote in Pallas for the TPU is a CUDA kernel
written for Hopper (``csrc/``, built at first use by ``native.py``).  It
imports nothing of the JAX package, and pyarrow only inside the functions
that read parquet or produce Arrow tables.

    import spark_rapids_tpu_torch as st
    from spark_rapids_tpu_torch import functions as F
    s = st.TorchSession.builder().get_or_create()          # on the card
    df = s.create_dataframe({"k": keys, "v": values})
    df.group_by("k").agg(F.sum(st.col("v")).alias("s")).order_by("k")
"""

from spark_rapids_tpu_torch.api import Column, DataFrame, Window, col, lit, \
    when
from spark_rapids_tpu_torch.session import TorchSession

__all__ = ["Column", "DataFrame", "TorchSession", "Window", "col", "lit",
           "when"]
