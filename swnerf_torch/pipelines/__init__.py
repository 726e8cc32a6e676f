"""Command-line pipelines (port of ``swnerf_tpu.pipelines``)."""
