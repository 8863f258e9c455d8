"""SQUIM: reference-free speech quality (STOI, PESQ, SI-SDR) and MOS against a non-matching reference."""

from .objective import SquimObjective, squim_objective_base, squim_objective_model
from .subjective import SquimSubjective, squim_subjective_base, squim_subjective_model

__all__ = [
    "SquimObjective",
    "SquimSubjective",
    "squim_objective_base",
    "squim_objective_model",
    "squim_subjective_base",
    "squim_subjective_model",
]
