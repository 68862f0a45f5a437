"""Model code of the port: config, layers, the decoder stack and the
paper's CNN actor graphs."""
