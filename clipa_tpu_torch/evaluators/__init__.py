"""Evaluators (not ported yet, ROADMAP A7): the prompt templates and
class names that the text pp ops read."""
