"""The plain reference of each configuration (float32, TF32 off), and
its control in float8.  Imports nothing of the port."""
