"""Entry points of the port (counterpart of ``repro.launch``)."""
