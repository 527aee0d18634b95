"""Roofline of the port: op traces and the three-term analysis."""
