"""Logging setup.

The reference uses `log` + `env_logger` driven by RUST_LOG
(reference: src/bin/gsearch.rs:135-139).  We mirror that with the standard
library logger driven by GSEARCH_TPU_LOG (debug/info/warning/error).
"""

import logging
import os

_CONFIGURED = False


def get_logger(name: str = "gsearch_tpu") -> logging.Logger:
    global _CONFIGURED
    if not _CONFIGURED:
        level = os.environ.get("GSEARCH_TPU_LOG", "info").upper()
        logging.basicConfig(
            level=getattr(logging, level, logging.INFO),
            format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        )
        _CONFIGURED = True
    return logging.getLogger(name)
