"""Model stack of the port: layers, attention blocks, the llama transformer."""
