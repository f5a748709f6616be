# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: solver.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0csolver.proto\x12\x0fgrove.solver.v1\"+\n\x08Quantity\x12\x10\n\x08resource\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x01\"\xa3\x01\n\x04Node\x12\x0c\n\x04name\x18\x01 \x01(\t\x12+\n\x08\x63\x61pacity\x18\x02 \x03(\x0b\x32\x19.grove.solver.v1.Quantity\x12\x31\n\x06labels\x18\x03 \x03(\x0b\x32!.grove.solver.v1.Node.LabelsEntry\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\x92\x01\n\x08PodGroup\x12\x0c\n\x04name\x18\x01 \x01(\t\x12)\n\x06\x64\x65mand\x18\x02 \x03(\x0b\x32\x19.grove.solver.v1.Quantity\x12\r\n\x05\x63ount\x18\x03 \x01(\x05\x12\x11\n\tmin_count\x18\x04 \x01(\x05\x12\x16\n\x0epack_level_key\x18\x05 \x01(\t\x12\x13\n\x0bpinned_node\x18\x06 \x01(\t\"\x8d\x02\n\x04Gang\x12\x0c\n\x04name\x18\x01 \x01(\t\x12)\n\x06groups\x18\x02 \x03(\x0b\x32\x19.grove.solver.v1.PodGroup\x12\x1a\n\x12required_level_key\x18\x03 \x01(\t\x12\x1b\n\x13preferred_level_key\x18\x04 \x01(\t\x12\x10\n\x08priority\x18\x05 \x01(\x05\x12\x13\n\x0bpinned_node\x18\x06 \x01(\t\x12\x18\n\x10spread_level_key\x18\x07 \x01(\t\x12\x1a\n\x12spread_min_domains\x18\x08 \x01(\x05\x12\x17\n\x0fspread_required\x18\t \x01(\x08\x12\x1d\n\x15spread_survivor_nodes\x18\n \x03(\t\"I\n\x0cSolveOptions\x12\x12\n\nchunk_size\x18\x01 \x01(\x05\x12\x11\n\tmax_waves\x18\x02 \x01(\x05\x12\x12\n\nstats_only\x18\x03 \x01(\x08\"\xa7\x01\n\x0cSolveRequest\x12$\n\x05nodes\x18\x01 \x03(\x0b\x32\x15.grove.solver.v1.Node\x12$\n\x05gangs\x18\x02 \x03(\x0b\x32\x15.grove.solver.v1.Gang\x12\x1b\n\x13topology_level_keys\x18\x03 \x03(\t\x12.\n\x07options\x18\x04 \x01(\x0b\x32\x1d.grove.solver.v1.SolveOptions\";\n\rPodAssignment\x12\r\n\x05group\x18\x01 \x01(\t\x12\x0c\n\x04node\x18\x02 \x01(\t\x12\r\n\x05\x63ount\x18\x03 \x01(\x05\"\x93\x01\n\tPlacement\x12\x0c\n\x04gang\x18\x01 \x01(\t\x12\x10\n\x08\x61\x64mitted\x18\x02 \x01(\x08\x12\x17\n\x0fplacement_score\x18\x03 \x01(\x02\x12\x18\n\x10\x63hosen_level_key\x18\x04 \x01(\t\x12\x33\n\x0b\x61ssignments\x18\x05 \x03(\x0b\x32\x1e.grove.solver.v1.PodAssignment\"V\n\rSolveResponse\x12.\n\nplacements\x18\x01 \x03(\x0b\x32\x1a.grove.solver.v1.Placement\x12\x15\n\rsolve_seconds\x18\x02 \x01(\x01\x32T\n\nGangSolver\x12\x46\n\x05Solve\x12\x1d.grove.solver.v1.SolveRequest\x1a\x1e.grove.solver.v1.SolveResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'solver_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _NODE_LABELSENTRY._options = None
  _NODE_LABELSENTRY._serialized_options = b'8\001'
  _QUANTITY._serialized_start=33
  _QUANTITY._serialized_end=76
  _NODE._serialized_start=79
  _NODE._serialized_end=242
  _NODE_LABELSENTRY._serialized_start=197
  _NODE_LABELSENTRY._serialized_end=242
  _PODGROUP._serialized_start=245
  _PODGROUP._serialized_end=391
  _GANG._serialized_start=394
  _GANG._serialized_end=663
  _SOLVEOPTIONS._serialized_start=665
  _SOLVEOPTIONS._serialized_end=738
  _SOLVEREQUEST._serialized_start=741
  _SOLVEREQUEST._serialized_end=908
  _PODASSIGNMENT._serialized_start=910
  _PODASSIGNMENT._serialized_end=969
  _PLACEMENT._serialized_start=972
  _PLACEMENT._serialized_end=1119
  _SOLVERESPONSE._serialized_start=1121
  _SOLVERESPONSE._serialized_end=1207
  _GANGSOLVER._serialized_start=1209
  _GANGSOLVER._serialized_end=1293
# @@protoc_insertion_point(module_scope)
