"""Host copy of `srsran_tpu/runtime/__init__.py`, held to it by `tests/test_torch_stack.py`.

Runtime/support layer: config, async logging, metrics, packet capture."""

from .config import AppConfig, load_config  # noqa: F401
from .logger import Logger, get_logger  # noqa: F401
from .metrics import CsvMetrics, MetricsHub, StdoutMetrics  # noqa: F401
from .pcap import MacPcap  # noqa: F401
