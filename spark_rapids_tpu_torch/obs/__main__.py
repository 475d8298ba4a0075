"""``python -m spark_rapids_tpu_torch.obs`` prints the process-wide
engine stats in Prometheus exposition format.  A fresh process reads
zeros; a serving process calls ``registry.prometheus_text()`` from its
own metrics endpoint."""

import sys

from spark_rapids_tpu_torch.obs import registry

sys.stdout.write(registry.prometheus_text())
