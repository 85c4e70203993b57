# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: knn_query.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0fknn_query.proto\x12\x16opensearch_jvector_tpu\"\xe8\x01\n\x10MethodParameters\x12\x16\n\tef_search\x18\x01 \x01(\x05H\x00\x88\x01\x01\x12\x1d\n\x10overquery_factor\x18\x02 \x01(\x05H\x01\x88\x01\x01\x12\x16\n\tthreshold\x18\x03 \x01(\x02H\x02\x88\x01\x01\x12\x19\n\x0crerank_floor\x18\x04 \x01(\x02H\x03\x88\x01\x01\x12\x18\n\x0buse_pruning\x18\x05 \x01(\x08H\x04\x88\x01\x01\x42\x0c\n\n_ef_searchB\x13\n\x11_overquery_factorB\x0c\n\n_thresholdB\x0f\n\r_rerank_floorB\x0e\n\x0c_use_pruning\"?\n\x07Rescore\x12\x1e\n\x11oversample_factor\x18\x01 \x01(\x02H\x00\x88\x01\x01\x42\x14\n\x12_oversample_factor\"\x1b\n\tVectorRow\x12\x0e\n\x06values\x18\x01 \x03(\x02\"\x8e\x03\n\x08KnnQuery\x12\r\n\x05\x66ield\x18\x01 \x01(\t\x12\x0e\n\x06vector\x18\x02 \x03(\x02\x12\x0e\n\x01k\x18\x03 \x01(\rH\x00\x88\x01\x01\x12\x19\n\x0cmax_distance\x18\x04 \x01(\x02H\x01\x88\x01\x01\x12\x16\n\tmin_score\x18\x05 \x01(\x02H\x02\x88\x01\x01\x12\x43\n\x11method_parameters\x18\x06 \x01(\x0b\x32(.opensearch_jvector_tpu.MethodParameters\x12\x30\n\x07rescore\x18\x07 \x01(\x0b\x32\x1f.opensearch_jvector_tpu.Rescore\x12\x12\n\nfilter_ids\x18\x08 \x03(\x03\x12\x1f\n\x12\x65xpand_nested_docs\x18\t \x01(\x08H\x03\x88\x01\x01\x12\x38\n\rquery_vectors\x18\n \x03(\x0b\x32!.opensearch_jvector_tpu.VectorRowB\x04\n\x02_kB\x0f\n\r_max_distanceB\x0c\n\n_min_scoreB\x15\n\x13_expand_nested_docs\"J\n\x0eQueryContainer\x12/\n\x03knn\x18\x01 \x01(\x0b\x32 .opensearch_jvector_tpu.KnnQueryH\x00\x42\x07\n\x05query\"q\n\rSearchRequest\x12\r\n\x05index\x18\x01 \x01(\t\x12\x35\n\x05query\x18\x02 \x01(\x0b\x32&.opensearch_jvector_tpu.QueryContainer\x12\x11\n\x04size\x18\x03 \x01(\rH\x00\x88\x01\x01\x42\x07\n\x05_size\" \n\x03Hit\x12\n\n\x02id\x18\x01 \x01(\x03\x12\r\n\x05score\x18\x02 \x01(\x02\"5\n\x08HitGroup\x12)\n\x04hits\x18\x01 \x03(\x0b\x32\x1b.opensearch_jvector_tpu.Hit\"\xa5\x01\n\x0eSearchResponse\x12)\n\x04hits\x18\x01 \x03(\x0b\x32\x1b.opensearch_jvector_tpu.Hit\x12\x0f\n\x07visited\x18\x02 \x01(\x03\x12\x10\n\x08\x65xpanded\x18\x03 \x01(\x03\x12\x10\n\x08reranked\x18\x04 \x01(\x03\x12\x33\n\tresponses\x18\x05 \x03(\x0b\x32 .opensearch_jvector_tpu.HitGroup2e\n\nKnnService\x12W\n\x06Search\x12%.opensearch_jvector_tpu.SearchRequest\x1a&.opensearch_jvector_tpu.SearchResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'knn_query_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _METHODPARAMETERS._serialized_start=44
  _METHODPARAMETERS._serialized_end=276
  _RESCORE._serialized_start=278
  _RESCORE._serialized_end=341
  _VECTORROW._serialized_start=343
  _VECTORROW._serialized_end=370
  _KNNQUERY._serialized_start=373
  _KNNQUERY._serialized_end=771
  _QUERYCONTAINER._serialized_start=773
  _QUERYCONTAINER._serialized_end=847
  _SEARCHREQUEST._serialized_start=849
  _SEARCHREQUEST._serialized_end=962
  _HIT._serialized_start=964
  _HIT._serialized_end=996
  _HITGROUP._serialized_start=998
  _HITGROUP._serialized_end=1051
  _SEARCHRESPONSE._serialized_start=1054
  _SEARCHRESPONSE._serialized_end=1219
  _KNNSERVICE._serialized_start=1221
  _KNNSERVICE._serialized_end=1322
# @@protoc_insertion_point(module_scope)
