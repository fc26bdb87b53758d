"""Prompt templates of the grounded video QA tasks."""
