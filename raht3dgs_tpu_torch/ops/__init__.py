"""Transform, order, quantizer and colour ops, and the CUDA scan kernel."""
