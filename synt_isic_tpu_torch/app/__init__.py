"""Thin clients over the generation engine: the desktop window (`gui`, PyQt5
or its headless stub `qt_compat`) and the browser UI (`webui`)."""
