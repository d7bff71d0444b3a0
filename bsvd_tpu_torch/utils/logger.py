"""The root logger of the port (counterpart of bsvd_tpu/utils/logger.py
get_root_logger, for one process): console, and a log file when asked."""

import logging

LOGGER = 'bsvd_tpu_torch'


def get_root_logger(log_file=None):
    """The port's logger ('bsvd_tpu_torch', INFO) with a console handler
    (added once) and, when ``log_file`` is given, a file handler writing
    there (in place of an earlier run's)."""
    logger = logging.getLogger(LOGGER)
    fmt = logging.Formatter('%(asctime)s %(levelname)s: %(message)s')
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(fmt)
        logger.addHandler(handler)
        logger.propagate = False
        logger.setLevel(logging.INFO)
    if log_file is not None:
        for old in [h for h in logger.handlers
                    if isinstance(h, logging.FileHandler)]:
            logger.removeHandler(old)
            old.close()
        handler = logging.FileHandler(log_file, 'w')
        handler.setFormatter(fmt)
        logger.addHandler(handler)
    return logger
