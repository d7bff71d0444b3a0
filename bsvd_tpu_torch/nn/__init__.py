"""Plain NHWC layers and the temporal shift of the port."""
