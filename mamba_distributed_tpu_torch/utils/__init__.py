"""FLOPs accounting and metrics logging of the port."""
