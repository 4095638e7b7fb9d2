"""Dense-family model of the port: layers, attention, blocks, Model."""
