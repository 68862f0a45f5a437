"""Model code of the port: config, layers and the decoder stack."""
