"""The plain reference: Qwen2 dense and MoE decoders in fp32 PyTorch
with TF32 off, one layer at a time, written from the configuration
files alone. It imports nothing of the program."""
