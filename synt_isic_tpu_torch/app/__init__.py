"""Thin clients over the generation engine: the browser UI (`webui`)."""
