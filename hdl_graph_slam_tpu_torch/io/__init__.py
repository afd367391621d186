from . import geodesy, trajectory
