"""The live web viewer (port of monogs_tpu/viewer/)."""
